// K8c: the adjoint of the path tracer's samples, the backward pass of the
// differentiable multi-scatter renderer (render/diff.py::
// render_multi_scatter_mc).
//
// Replaces the reverse mode of deepestscatter_tpu/render/pathtracer.py::
// _scatter_loop's oracle body (lines 766-845) under its differentiable scan
// (lines 847-865), reached from deepestscatter_tpu/render/diff.py::
// render_multi_scatter_mc (line 374): XLA runs the bounce loop there as a
// rematerialised scan of max_total_steps iterations over every ray and
// differentiates it step by step.  The forward is K4 (csrc/pathtrace.cu):
// sample k of pixel r with the seed seed_base ^ ((sub_first + k) *
// 0x9E3779B1), one radiance record a sample.  For the upstream gradient
// g[k][r] of each record, K8c adds the gradient of sum g . radiance to the
// density grid, the baked in-scatter grid, light_dir and light_radiance,
// and writes each sample's gradient of its box entry and its direction.
//
// A sample is a chain of free flights.  Flight d starts at x_d along w_d
// with T = 1 and draws od_d; its steps are a_j = a_{j-1} + w_d step (a_0 =
// x_d), sigma_j = dm trilinear(density, a_j / bbox), T_j = T_{j-1}
// exp(-sigma_j step).  It ends at the first step K with od_d > T_K (the
// crossing), on leaving the box, at the step cap or at the depth test.  A
// crossing scatters at s = a_K - w_d back, back = log(max(od, 1e-20) /
// max(T_K, 1e-20)) / max(sigma_K, 1e-10) (ops/march.py:44); in the box it
// adds next-event estimation, L p(cos(light, w_d)) T_in(s) ratio weight
// (the full Mie phase at depth 1 of the all-scatter mode, else the chopped
// phase), and the next flight starts at x_{d+1} = s along w_{d+1} =
// normalize(from_onb(local(u_cdf, u_phi), w_d)) (the uniforms and the
// phase tables are constants).  A sample that leaves the box with
// sample_sky adds weight (sky_gradient(w_d) + the sun disc at depth 1).
// Roulette divides the weight by the constant q.  The decisions (which
// step crosses, the roulette, how the sample ends) are steps and have no
// gradient; everything else is differentiable:
//
//   - NEE at s: d light_radiance, d light_dir and d w_d through the phase
//     table's lerp slope, d T_in's eight texels, d s through T_in's
//     trilinear slope.
//   - The scatter point: with bbar = -(sbar . w_d), d back / d sigma_j =
//     step / max(sigma_K, 1e-10) at every step j <= K (d log T_K / d sigma_j
//     = -step; zero where T_K < 1e-20) and, at j = K, also -back /
//     max(sigma_K, 1e-10) (zero where sigma_K < 1e-10).  So the flight's
//     adjoint is one re-march of its K steps: step j adds its sigma
//     adjoint times dm times the trilinear weights to the density texels
//     and its slope to xbar_d and, times j step, to wbar_d; s adds sbar to
//     xbar_d and sbar (K step - back) to wbar_d.  No step is stored.
//   - The new direction: the Jacobian of make_onb (ops/rng.py; its sign
//     branch on n_z >= 0 as the forward took it) and of the normalisation.
//   - The sky: sky_gradient's slope in w_y where its clip is not active; the
//     sun disc is a step.
//
// The design: one thread a (sample k, pixel r) item.
//   Pass 1 replays the sample with K4's own functions (begin_item,
//   march_steps at K = 1, scatter; csrc/pathtrace.cuh), so its decisions
//   are K4's bit for bit, and writes each flight's start (x_d, w_d), the
//   weight, the crossing's sigma_K, T_K and back, the step count K_d, the
//   depth and how the flight ended into a scratch buffer of max_segments
//   flights an item (max_depth + 1: a sample has at most max(1, max_depth
//   - 1) flights).  It writes the replayed radiance, steps and in-box
//   scatters as K4's record, which the callers hold bitwise against K4's.
//   Pass 2 sweeps the flights from the last to the first, carrying the
//   adjoints (xbar, wbar) of the next flight's start.  A flight that ended
//   in an in-box scatter recomputes a_K and s with the forward's
//   expressions, takes NEE's adjoint and re-marches its steps for the
//   density adjoint; a run of steps in one cell sums its terms in
//   registers before its eight float64 atomics (as the sun march's adjoint
//   does, csrc/diff.cu).  The grid adjoints are float64 sums (atomicAdd);
//   light_dir's and light_radiance's are per-thread float32 sums, summed in
//   float64 over each block into a partial row a block (the wrapper sums
//   the rows, so they are deterministic); d entry and d dirs are written a
//   sample, [n_samples][n][3].
// The wrapper (render/diff.py::launch_path_adjoint) splits the pixels into
// launches of m pixels so that the scratch stays under its budget.
//
// Every forward expression is K4's; the build uses -fmad=false.  The
// adjoint's sums run in another order than autograd's, and the atomics in
// an order that changes from run to run.
#include "pathtrace.cuh"
#include "taps.cuh"

namespace ds {
namespace path {

// Threads a block.
constexpr int kThreads = 128;

// How a flight ended.
enum : int {
  kEndCut = 0,      // the step cap, or the depth test of a free step
  kEndExit = 1,     // a free step left the box
  kEndScatter = 2,  // a crossing whose scatter point lies in the box
  kEndEscape = 3,   // a crossing whose scatter point lies outside the box
};

// One flight of a sample, as pass 1 records it.
struct Segment {
  float x[3], w[3];  // start and direction
  float weight;      // the path weight during the flight
  float sigma;       // sigma_K (density x dm) at the crossing step
  float trans;       // T_K after the crossing step
  float back;        // the pull-back from a_K to the scatter point
  int steps;         // K: the flight's march steps
  int info;          // depth << 2 | end
};

// Partial rows (a block each) of an items launch.
inline int64_t adjoint_blocks(int64_t items) { return (items + kThreads - 1) / kThreads; }

// Pass 1: the sample S (begun by begin_item) to its end with K4's
// functions, each flight recorded into seg[0 ..).  Returns the flights.
template <typename T>
__device__ __forceinline__ int replay(Sample& S, const T* __restrict__ dens,
                                      const T* __restrict__ insc, int nx, int ny, int nz,
                                      const float* __restrict__ eval_rows,
                                      const float* __restrict__ inv, const PtConsts& c,
                                      Segment* __restrict__ seg, int max_segments) {
  int n = 0;
  while (n < max_segments) {
    Segment& g = seg[n];
    g.x[0] = S.px;
    g.x[1] = S.py;
    g.x[2] = S.pz;
    g.w[0] = S.dx;
    g.w[1] = S.dy;
    g.w[2] = S.dz;
    g.weight = S.weight;
    g.sigma = g.trans = g.back = 0.0f;
    const int depth = S.depth, steps0 = S.steps;
    Crossing X;
    int state;
    do {
      state = march_steps<1>(S, X, dens, nx, ny, nz, c);
    } while (state == kMarching);
    g.steps = S.steps - steps0;
    ++n;
    if (state == kEnded) {
      // A cap or the depth test leaves the sample in the box; a free step
      // out of the box leaves it outside.
      g.info = depth << 2 | (in_box(S.px, S.py, S.pz, c.bbox) ? kEndCut : kEndExit);
      return n;
    }
    g.sigma = X.density;
    g.trans = X.tn;
    g.back = back_distance(S.od, X.tn, X.density);
    const bool inb = in_box(X.ax - S.dx * g.back, X.ay - S.dy * g.back, X.az - S.dz * g.back,
                            c.bbox);
    g.info = depth << 2 | (inb ? kEndScatter : kEndEscape);
    if (resolve(S, X, insc, nx, ny, nz, eval_rows, inv, c)) return n;
  }
  return n;
}

// The phase value at cos (scatter's lerp of column col = chopped ? 2 : 0)
// and its slope d p / d cos (0 where the lerp's fraction is pinned).
__device__ __forceinline__ float phase_lerp(const float* __restrict__ eval_rows, int n_phase,
                                            float cosl, bool chopped, float* slope) {
  const float t = ((cosl + 1.0f) * 0.5f) * (float)n_phase - 0.5f;
  float frac;
  const int i0 = row_index(t, n_phase, frac);
  const int col = chopped ? 2 : 0;
  const float e0 = eval_rows[4 * i0 + col], e1 = eval_rows[4 * i0 + col + 1];
  *slope = floorf(t) < 0.0f ? 0.0f : (e1 - e0) * (0.5f * (float)n_phase);
  return e0 * (1.0f - frac) + e1 * frac;
}

// The adjoint of new_direction(u_cdf, u_phi) at the previous direction d:
// adds d/d d of gout . new_direction to dd.
__device__ __forceinline__ void new_direction_adjoint(const float* __restrict__ inv, int n_inv,
                                                      float u_cdf, float u_phi, const float* d,
                                                      const float* gout, float* dd) {
  float frac;
  const int i0 = row_index(u_cdf * (float)n_inv - 0.5f, n_inv, frac);
  const float m = inv[2 * i0] * (1.0f - frac) + inv[2 * i0 + 1] * frac;
  const float ct = 2.0f * m - 1.0f;
  const float phi = u_phi * kTwoPi;
  const float st = sqrtf(fmaxf(1.0f - ct * ct, 0.0f));
  const float lx = st * cosf(phi), ly = st * sinf(phi), lz = ct;
  const float nx = d[0], ny = d[1], nz = d[2];
  const float sign = nz >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + nz);
  const float b = (nx * ny) * a;
  const float tx = 1.0f + (sign * (nx * nx)) * a, ty = sign * b, tz = (-sign) * nx;
  const float bx = b, by = sign + (ny * ny) * a, bz = -ny;
  const float o[3] = {(lx * tx + ly * bx) + lz * nx, (lx * ty + ly * by) + lz * ny,
                      (lx * tz + ly * bz) + lz * nz};
  const float len = sqrtf((o[0] * o[0] + o[1] * o[1]) + o[2] * o[2]);
  const float w[3] = {o[0] / len, o[1] / len, o[2] / len};
  const float dot = (gout[0] * w[0] + gout[1] * w[1]) + gout[2] * w[2];
  float ob[3], P[3], Q[3];
  for (int i = 0; i < 3; ++i) {
    ob[i] = (gout[i] - w[i] * dot) / len;  // through the normalisation
    P[i] = lx * ob[i];                     // the tangent's adjoint
    Q[i] = ly * ob[i];                     // the bitangent's adjoint
  }
  // d a / d n_z = a^2; d b / d n = (n_y a, n_x a, n_x n_y a^2).
  const float a2 = a * a;
  dd[0] += lz * ob[0] + P[0] * (2.0f * sign * nx * a) + P[1] * (sign * ny * a) - P[2] * sign +
           Q[0] * (ny * a);
  dd[1] += lz * ob[1] + P[1] * (sign * nx * a) + Q[0] * (nx * a) + Q[1] * (2.0f * ny * a) - Q[2];
  dd[2] += lz * ob[2] + P[0] * (sign * nx * nx * a2) + P[1] * (sign * nx * ny * a2) +
           Q[0] * (nx * ny * a2) + Q[1] * (ny * ny * a2);
}

// The adjoint of add_sky_exit for the upstream gout: d w (the sky
// gradient's slope in w_y inside its clip) into dw, the sun disc's light
// into dl.
__device__ __forceinline__ void sky_exit_adjoint(const PtConsts& c, const float* w, int depth,
                                                 float weight, const float* gout, float* dw,
                                                 float* dl) {
  const float t = (w[1] + 0.5f) / 1.5f;
  if (t >= 0.0f && t <= 1.0f) {
    float s = 0.0f;
    for (int i = 0; i < 3; ++i) s += gout[i] * ((c.sky[i] - c.ground[i]) * weight);
    dw[1] += s / 1.5f;
  }
  if (depth == 1 && cos_to_sun(c, w[0], w[1], w[2]) > c.sun_cos_half) {
    for (int i = 0; i < 3; ++i) dl[i] += gout[i] * weight;
  }
}

// What a thread adds to light_dir's and light_radiance's gradients.
struct LightGrads {
  float dir[3], rad[3];
};

// The adjoint of NEE at the scatter point s along w for the upstream gout:
// the in-scatter texels (Add), d s into ds, d w into dw, the light's into L.
template <class Add>
__device__ __forceinline__ void nee_adjoint(const float* __restrict__ insc,
                                            const diff::Grid3& gr,
                                            const float* __restrict__ eval_rows,
                                            const PtConsts& c, const float* s, const float* w,
                                            bool chopped, float weight, const float* gout,
                                            double* d_insc, float* ds, float* dw, LightGrads& L,
                                            const Add& add) {
  float slope;
  const float p = phase_lerp(eval_rows, c.n_phase, cos_to_sun(c, w[0], w[1], w[2]), chopped,
                             &slope);
  float u[3];
  diff::unit_coords(gr, s, u);
  const diff::Taps tp = diff::taps_at(gr, u[0], u[1], u[2]);
  const float sun_t = diff::taps_value(insc, tp);
  const float scale = (p * sun_t) * c.sun_ratio;
  // radiance_i += (L_i scale) weight.
  float sbar = 0.0f;
  for (int i = 0; i < 3; ++i) {
    L.rad[i] += gout[i] * (scale * weight);
    sbar += gout[i] * (c.radiance[i] * weight);
  }
  const float pbar = (sbar * sun_t) * c.sun_ratio;
  const float tbar = (sbar * p) * c.sun_ratio;
  const float cbar = pbar * slope;  // cos = -light . w
  for (int i = 0; i < 3; ++i) {
    L.dir[i] -= cbar * w[i];
    dw[i] -= cbar * c.light[i];
  }
  float dp[3];
  diff::taps_adjoint(insc, gr, tp, tbar, d_insc, dp, add);
  for (int i = 0; i < 3; ++i) ds[i] += dp[i];
}

// The re-march of flight g for its sigma adjoints (c0 at steps 1 .. K-1,
// cK at step K): the density texels (runs of steps in one cell summed in
// registers first), the slopes summed in float64 over the flight into dx
// and, times j step, into dw.
template <class Add>
__device__ __forceinline__ void flight_adjoint(const float* __restrict__ dens,
                                               const diff::Grid3& gr, const PtConsts& c,
                                               const Segment& g, float c0, float cK,
                                               double* d_dens, float* dx, float* dw,
                                               const Add& add) {
  float qx = g.x[0], qy = g.x[1], qz = g.x[2];
  int key = -1, run_idx[8];
  float run_v[8];
  double sx[3] = {0.0, 0.0, 0.0}, sw[3] = {0.0, 0.0, 0.0};
  for (int j = 1; j <= g.steps; ++j) {
    qx = qx + g.w[0] * c.step;
    qy = qy + g.w[1] * c.step;
    qz = qz + g.w[2] * c.step;
    const float q[3] = {qx, qy, qz};
    float u[3];
    diff::unit_coords(gr, q, u);
    const diff::Taps tp = diff::taps_at(gr, u[0], u[1], u[2]);
    const float sb = (j == g.steps ? cK : c0) * c.dm;  // d trilinear
    if (tp.idx[0] != key) {
      if (key >= 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k) add(d_dens + run_idx[k], run_v[k]);
      }
      key = tp.idx[0];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        run_idx[k] = tp.idx[k];
        run_v[k] = sb * tp.w[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) run_v[k] += sb * tp.w[k];
    }
    float dp[3];
    diff::taps_point_slope(dens, gr, tp, sb, dp);
    const float dist = (float)j * c.step;
    for (int a = 0; a < 3; ++a) {
      sx[a] += (double)dp[a];
      sw[a] += (double)(dp[a] * dist);
    }
  }
  if (key >= 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) add(d_dens + run_idx[k], run_v[k]);
  }
  for (int a = 0; a < 3; ++a) {
    dx[a] += (float)sx[a];
    dw[a] += (float)sw[a];
  }
}

// Pass 2: the flights seg[0 .. n) of the sample with seed `seed`, stream
// `id` swept from the last, for the upstream gout of its radiance.  Adds
// the grids' and the light's gradients; writes d/d entry into de and d/d
// the pixel's direction dir into dd.  Returns the steps it re-marched.
template <class Add>
__device__ __forceinline__ int sweep(const float* __restrict__ dens,
                                      const float* __restrict__ insc, const diff::Grid3& gr,
                                      const float* __restrict__ eval_rows,
                                      const float* __restrict__ inv, const PtConsts& c,
                                      const Segment* __restrict__ seg, int n, uint32_t seed,
                                      uint32_t id, const float* dir, const float* gout,
                                      double* d_dens, double* d_insc, float* de, float* dd,
                                      LightGrads& L, const Add& add) {
  float xb[3] = {0.0f, 0.0f, 0.0f}, wb[3] = {0.0f, 0.0f, 0.0f};
  int remarched = 0;
  for (int d = n - 1; d >= 0; --d) {
    const Segment& g = seg[d];
    const int end = g.info & 3, depth = g.info >> 2;
    float dw[3] = {0.0f, 0.0f, 0.0f};
    if (end != kEndScatter) {
      if ((c.flags & kSky) && end != kEndCut) {
        sky_exit_adjoint(c, g.w, depth, g.weight, gout, dw, L.rad);
      }
      for (int a = 0; a < 3; ++a) {
        xb[a] = 0.0f;  // the flight's end is not used
        wb[a] = dw[a];
      }
      continue;
    }
    if (wb[0] != 0.0f || wb[1] != 0.0f || wb[2] != 0.0f) {
      const uint32_t ctr = (uint32_t)depth * 4u;
      new_direction_adjoint(inv, c.n_inv, hash_uniform(seed, id, ctr + 1u),
                            hash_uniform(seed, id, ctr + 2u), g.w, wb, dw);
    }
    // a_K and the scatter point, with the forward's expressions.
    float ax = g.x[0], ay = g.x[1], az = g.x[2];
    for (int j = 0; j < g.steps; ++j) {
      ax = ax + g.w[0] * c.step;
      ay = ay + g.w[1] * c.step;
      az = az + g.w[2] * c.step;
    }
    const float s[3] = {ax - g.w[0] * g.back, ay - g.w[1] * g.back, az - g.w[2] * g.back};
    float xs[3] = {xb[0], xb[1], xb[2]};
    const bool chopped = depth != 1 || (c.flags & kChopped1);
    nee_adjoint(insc, gr, eval_rows, c, s, g.w, chopped, g.weight, gout, d_insc, xs, dw, L, add);
    // s = a_K - w back: d/d x_d = I, d/d w = (K step - back) I, d/d back = -w.
    const float bbar = -((xs[0] * g.w[0] + xs[1] * g.w[1]) + xs[2] * g.w[2]);
    const float dist = (float)g.steps * c.step;
    float dx[3];
    for (int a = 0; a < 3; ++a) {
      dx[a] = xs[a];
      dw[a] += xs[a] * dist - xs[a] * g.back;
    }
    const float sig = fmaxf(g.sigma, 1e-10f);
    const float c0 = g.trans >= 1e-20f ? (bbar * c.step) / sig : 0.0f;
    const float cK = c0 + (g.sigma >= 1e-10f ? bbar * (-g.back / sig) : 0.0f);
    if (c0 != 0.0f || cK != 0.0f) {
      flight_adjoint(dens, gr, c, g, c0, cK, d_dens, dx, dw, add);
      remarched += g.steps;
    }
    for (int a = 0; a < 3; ++a) {
      xb[a] = dx[a];
      wb[a] = dw[a];
    }
  }
  for (int a = 0; a < 3; ++a) {
    de[a] = xb[a];
    dd[a] = 0.0f;
  }
  if (c.flags & kResample) {
    // The first direction was redrawn around the pixel's (counters 0, 1).
    if (wb[0] != 0.0f || wb[1] != 0.0f || wb[2] != 0.0f) {
      new_direction_adjoint(inv, c.n_inv, hash_uniform(seed, id, 0u), hash_uniform(seed, id, 1u),
                            dir, wb, dd);
    }
  } else {
    for (int a = 0; a < 3; ++a) dd[a] = wb[a];
  }
  return remarched;
}

// Item i of a launch over pixels r0 .. r0 + m - 1 of n: sample k = i / m of
// pixel r = r0 + i % m.  Both passes; the record and d entry / d dirs at
// [k][r]; L gets the item's light gradients; remarch (where given) the
// steps pass 2 re-marched.  Items of pixels without a box hit write zeros.
template <class Add>
__device__ __forceinline__ void adjoint_item(
    int64_t i, int64_t n, int64_t r0, int64_t m, const float* __restrict__ dens,
    const float* __restrict__ insc, int nx, int ny, int nz, const diff::Grid3& gr,
    const float* __restrict__ eval_rows, const float* __restrict__ inv,
    const float* __restrict__ entry, const float* __restrict__ dirs,
    const uint8_t* __restrict__ hit, const int64_t* __restrict__ ray_ids, const PtConsts& c,
    uint32_t seed_base, uint32_t sub_first, const float* __restrict__ g_rec,
    Segment* __restrict__ scratch, int max_segments, float* __restrict__ rec_rad,
    int32_t* __restrict__ rec_work, double* d_dens, double* d_insc, float* __restrict__ d_entry,
    float* __restrict__ d_dirs, int32_t* __restrict__ remarch, LightGrads& L, const Add& add) {
  const int64_t r = r0 + i % m, k = i / m;
  const int64_t item = k * n + r;  // K4's item (sample-major)
  float de[3] = {0.0f, 0.0f, 0.0f}, dd[3] = {0.0f, 0.0f, 0.0f};
  int remarched = 0;
  if (hit[r]) {
    Sample S;
    if (begin_item(S, item, n, entry, dirs, hit, ray_ids, inv, c, seed_base, sub_first, nullptr,
                   rec_rad, rec_work)) {
      Segment* seg = scratch + i * (int64_t)max_segments;
      const int flights = replay(S, dens, insc, nx, ny, nz, eval_rows, inv, c, seg, max_segments);
      write_record(S, item, rec_rad, rec_work);
      const float* gout = g_rec + 3 * item;
      if (gout[0] != 0.0f || gout[1] != 0.0f || gout[2] != 0.0f) {
        remarched = sweep(dens, insc, gr, eval_rows, inv, c, seg, flights, S.seed, S.id,
                          dirs + 3 * r, gout, d_dens, d_insc, de, dd, L, add);
      }
    }
  } else {
    for (int a = 0; a < 3; ++a) rec_rad[3 * item + a] = 0.0f;
    rec_work[2 * item] = rec_work[2 * item + 1] = 0;
  }
  for (int a = 0; a < 3; ++a) {
    d_entry[3 * item + a] = de[a];
    d_dirs[3 * item + a] = dd[a];
  }
  if (remarch != nullptr) remarch[item] = remarched;
}

}  // namespace path
}  // namespace ds

#ifndef DS_HOST_EMULATION

// Sums each thread's v[6] over the block into out[6] (thread 0 writes), in
// a fixed order.
__device__ __forceinline__ void block_sum6(double* v, double* out) {
  __shared__ double warp_sums[ds::path::kThreads / 32][6];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[a] += __shfl_down_sync(0xffffffffu, v[a], off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    for (int a = 0; a < 6; ++a) warp_sums[warp][a] = v[a];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int a = 0; a < 6; ++a) {
      double acc = 0.0;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) acc += warp_sums[w][a];
      out[a] = acc;
    }
  }
}

// A thread an item (adjoint_item); partials[6 * block]: the block's
// light_dir and light_radiance gradients.
__global__ void __launch_bounds__(ds::path::kThreads) path_adjoint_kernel(
    const float* __restrict__ dens, const float* __restrict__ insc, int nx, int ny, int nz,
    ds::diff::Grid3 gr, const float* __restrict__ eval_rows, const float* __restrict__ inv,
    const float* __restrict__ entry, const float* __restrict__ dirs,
    const uint8_t* __restrict__ hit, const int64_t* __restrict__ ray_ids, int64_t n, int64_t r0,
    int64_t m, int64_t n_items, ds::PtConsts c, uint32_t seed_base, uint32_t sub_first,
    const float* __restrict__ g_rec, ds::path::Segment* __restrict__ scratch, int max_segments,
    float* __restrict__ rec_rad, int32_t* __restrict__ rec_work, double* d_dens, double* d_insc,
    float* __restrict__ d_entry, float* __restrict__ d_dirs, int32_t* __restrict__ remarch,
    double* __restrict__ partials) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  ds::path::LightGrads L = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  if (i < n_items) {
    ds::path::adjoint_item(i, n, r0, m, dens, insc, nx, ny, nz, gr, eval_rows, inv, entry, dirs,
                           hit, ray_ids, c, seed_base, sub_first, g_rec, scratch, max_segments,
                           rec_rad, rec_work, d_dens, d_insc, d_entry, d_dirs, remarch, L,
                           ds::diff::AddTo());
  }
  double v[6];
  for (int a = 0; a < 3; ++a) {
    v[a] = L.dir[a];
    v[3 + a] = L.rad[a];
  }
  block_sum6(v, partials + 6 * (int64_t)blockIdx.x);
}

extern "C" {

// The bytes of one scratch flight record.
int ds_path_segment_bytes() { return (int)sizeof(ds::path::Segment); }

// The partial rows of a launch of m pixels x n_samples.
int64_t ds_path_adjoint_blocks(int64_t m, int n_samples) {
  return ds::path::adjoint_blocks(m * (int64_t)n_samples);
}

// K8c over pixels r0 .. r0 + m - 1 of n.  The scene arguments (float32
// textures), consts, ground, max_steps, max_depth, rr_start, flags,
// seed_base, sub_first and n_samples are ds_pathtrace's.  g_rec: the
// upstream of the records, [n_samples][n][3]; scratch: n_samples x m x
// max_segments flight records (ds_path_segment_bytes each); rec_rad
// [n_samples][n][3] and rec_work [n_samples][n][2]: the replayed records
// (zeros where a pixel has no hit); d_dens, d_insc: float64 grids, zeroed
// by the caller and added to; d_entry, d_dirs: [n_samples][n][3];
// remarch: NULL or [n_samples][n] int32, the steps each sample's adjoint
// re-marched; partials: float64 [ds_path_adjoint_blocks(m, n_samples)][6]
// (light_dir's and light_radiance's gradients a block).
int ds_path_adjoint(const float* dens, const float* insc, int nx, int ny, int nz,
                    const float* eval_rows, int n_phase, const float* inv_rows, int n_inv,
                    const float* entry, const float* dirs, const uint8_t* hit,
                    const int64_t* ray_ids, int64_t n, int64_t r0, int64_t m,
                    const float* consts, const float* ground, int max_steps, int max_depth,
                    int rr_start, int flags, uint32_t seed_base, uint32_t sub_first,
                    int n_samples, const float* g_rec, void* scratch, int max_segments,
                    float* rec_rad, int32_t* rec_work, double* d_dens, double* d_insc,
                    float* d_entry, float* d_dirs, int32_t* remarch, double* partials,
                    void* stream) {
  const int64_t n_items = m * (int64_t)n_samples;
  if (n_items <= 0) return 0;
  if (max_segments < 1 || r0 < 0 || r0 + m > n) return (int)cudaErrorInvalidValue;
  const ds::PtConsts c =
      ds::pt_consts(consts, ground, max_steps, max_depth, rr_start, n_phase, n_inv, flags);
  const ds::diff::Grid3 gr = ds::diff::grid3(nx, ny, nz, c.bbox);
  path_adjoint_kernel<<<(unsigned)ds::path::adjoint_blocks(n_items), ds::path::kThreads, 0,
                        (cudaStream_t)stream>>>(
      dens, insc, nx, ny, nz, gr, eval_rows, inv_rows, entry, dirs, hit, ray_ids, n, r0, m,
      n_items, c, seed_base, sub_first, g_rec, (ds::path::Segment*)scratch, max_segments, rec_rad,
      rec_work, d_dens, d_insc, d_entry, d_dirs, remarch, partials);
  return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // DS_HOST_EMULATION
