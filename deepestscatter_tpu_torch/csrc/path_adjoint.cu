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
// The design: two kernels launched back to back on the stream.
//   path_replay_kernel replays the samples on K4's persistent item queue
//   (csrc/pathtrace.cu's pathtrace_items_kernel: the grid fills the card
//   once; a lane whose sample ends takes the next item by ballot, one
//   atomicAdd a warp and a shuffle of the base; a pixel without a box hit
//   writes zeros and is skipped), kLookahead march steps a chunk with K4's
//   own march_steps and resolve (csrc/pathtrace.cuh), so its decisions and
//   records are K4's bit for bit.  A flight's start (x_d, w_d, the weight)
//   is written to its Segment when the flight opens, the rest (the step
//   count K_d, the crossing's sigma_K, T_K and pull-back, the scatter point
//   s, the depth and how the flight ended) when it ends, into a scratch of
//   max_segments flights an item (max_depth + 1: a sample has at most
//   max(1, max_depth - 1) flights).  It writes each sample's record as K4's
//   (which the callers hold bitwise against K4's), zeros for d entry and d
//   dirs, and appends each sample with an upstream and a flight to the
//   sweep's work list, a warp at a time (ballot, one atomicAdd): those that
//   may re-march kLongSteps steps or more at its front, the others at its
//   back, so that the sweep starts the long ones first.
//   path_sweep_kernel gives each sample of the list a group of kSweepLanes
//   lanes, taken from the list (its front, then its back) by a group queue
//   (one atomicAdd a sample) over a persistent grid.  The group sweeps the
//   flights from the last to the first, carrying the adjoints (xbar, wbar)
//   of the next flight's start.  Every lane computes the scalar part of a
//   flight (flight_head: the sky's adjoint, the new direction's, NEE's at
//   the stored s, the pull-back's, the sigma adjoints c0 of steps 1 .. K-1
//   and cK of step K), NEE's eight in-scatter atomics split over the lanes.
//   A flight that ended in an in-box scatter is re-marched in chunks of G
//   steps, lane l on step c G + l + 1 of chunk c (remarch_lane): its
//   position walks the forward's chain of additions a_j = a_{j-1} + w step
//   from the chunk's start, so every position is the forward's bit for
//   bit; the slope sums are float64 over the group; runs of lanes in one
//   cell are merged by group_deposit's segmented scan (csrc/lanes.cuh, as
//   K8b's adjoint does) before their float64 atomics.  Lane 0 writes d
//   entry and d dirs, and adds the sample's light gradients (float32 over
//   its flights, as the first design sums them) in float64; each block
//   sums its lanes' into a partial row (the wrapper sums the rows).  A
//   sample's outputs do not depend on which group took it.
// The wrapper (render/diff.py::launch_path_adjoint) splits the pixels into
// launches of m pixels so that the scratch (flights and work list) stays
// under its budget.
//
// The first design, a thread an item doing both passes (replay at
// lookahead 1, then sweep: each flight re-marched by one thread, runs of
// steps in one cell summed in registers), is csrc/path_adjoint_first.cuh;
// csrc/path_adjoint_variants.cu builds it as a kernel and times it against
// the package's (probes/march_variants.py --path-only, chip_smoke.py).  What
// held it back (H100 80GB HBM3 at 700 W, the multi-scatter frame point:
// 262,144 pixels x 2 samples): 124 registers for both passes (16 of 64
// warps an SM), warps of 32 neighbouring pixels in lockstep over paths of
// 0 to 1,800 steps, 54 % of the items on pixels that miss the box, and
// each re-march serial in one thread; its replay alone (a zero upstream)
// took 2.54-2.61 of its 3.65-3.69 ms, K4 on the same samples 1.75-1.76.
// Measured against it in turns (PERF.md, K8c): the replay here takes
// K4's time (72 registers; bounds of threads alone gave 64 and were
// slower); the sweep is issue-bound, not bound by its atomics or its
// occupancy: a group's chunk runs some 300 instructions, and a warp's
// groups, each on its own sample, run apart (their group-masked shuffles
// take the divergent path).  4 to 16 lanes a sample cost the same, 32 more
// (csrc/path_adjoint_variants.cu times them); a group an entry over a grid,
// each lane adding its own step, the lanes on contiguous blocks of a
// flight's steps (whose scattered atomics cost more than the scan they
// save), a warp running its groups in step and groups taking entries in
// batches or in a fixed stride were slower (measured and removed).  Taking
// the long samples first (kLongSteps) cut the sweep's tail.
//
// Every forward expression is K4's; the build uses -fmad=false.  The
// adjoint's sums run in another order than autograd's, and the atomics in
// an order that changes from run to run.
#include "lanes.cuh"
#include "pathtrace.cuh"
#include "taps.cuh"

namespace ds {
namespace path {

// Threads a block of each kernel.
constexpr int kThreads = 128;
// The replay's launch bounds: the resident blocks a SM asked of nvcc (1:
// 72 registers; a bound of threads alone gave 64 and was ~5 % slower).
constexpr int kReplayBlocks = 1;
// The sweep's lanes a sample (G; 4 to 16 measure the same, 32 slower).
constexpr int kSweepLanes = 8;
// The sweep's launch bounds: the resident blocks a SM asked of nvcc (4:
// 120 registers; 6 (80) measure the same, 8 (64, spilling) slower).
constexpr int kSweepBlocks = 4;
// A sample that may re-march at least this many steps goes to the front of
// the work list, the others to its back: the sweep takes the long ones
// first (64 measured best of 0, 32, 64, 128, 256 and 512).
constexpr int kLongSteps = 64;

// How a flight ended.
enum : int {
  kEndCut = 0,      // the step cap, or the depth test of a free step
  kEndExit = 1,     // a free step left the box
  kEndScatter = 2,  // a crossing whose scatter point lies in the box
  kEndEscape = 3,   // a crossing whose scatter point lies outside the box
};

// One flight of a sample, as the replay records it (64 bytes).
struct Segment {
  float x[3], w[3];  // start and direction
  float s[3];        // a crossing's scatter point a_K - w back
  float weight;      // the path weight during the flight
  float sigma;       // sigma_K (density x dm) at the crossing step
  float trans;       // T_K after the crossing step
  float back;        // the pull-back from a_K to the scatter point
  int steps;         // K: the flight's march steps
  int info;          // depth << 2 | end
  int pad;
};

// The scratch bytes of a pixel: its samples' flights and work-list entries.
inline int64_t pixel_bytes(int n_samples, int max_segments) {
  return (int64_t)n_samples * ((int64_t)max_segments * (int64_t)sizeof(Segment) + 8);
}

// A launch over pixels r0 .. r0 + m - 1 of n: its inputs (ds_pathtrace's
// scene and constants, the upstream g_rec [n_samples][n][3]) and outputs.
// Item i of the launch is sample k = i / m of pixel r = r0 + i % m, K4's
// item k n + r (sample-major).
struct PathArgs {
  const float* dens;
  const float* insc;
  int nx, ny, nz;
  diff::Grid3 gr;
  const float* eval_rows;
  const float* inv;
  const float* entry;
  const float* dirs;
  const uint8_t* hit;
  const int64_t* ray_ids;
  int64_t n, r0, m, n_items;
  PtConsts c;
  uint32_t seed_base, sub_first;
  const float* g_rec;
  Segment* seg;  // max_segments flights an item
  int max_segments;
  float* rec_rad;      // [n_samples][n][3]: the replayed records
  int32_t* rec_work;   // [n_samples][n][2]
  double* d_dens;      // float64 grids, added to
  double* d_insc;
  float* d_entry;      // [n_samples][n][3]
  float* d_dirs;
  int32_t* remarch;    // NULL or [n_samples][n]: the steps re-marched
  int64_t* list;       // the sweep's work list (list_entry), n_items long
  // The replay's queue head, the list's front length, the sweep's queue
  // head, the list's back length.
  unsigned long long* counters;
  double* partials;    // [blocks][6]: light_dir's and light_radiance's gradients
};

// A work-list entry: item i with its flights.
__device__ __forceinline__ int64_t list_entry(int64_t i, int flights) {
  return (int64_t)((uint64_t)i << 32 | (uint32_t)flights);
}

// Position `at` of the front (at < n_front) or the back of the list: the
// front fills from the list's start, the back from its end.
__device__ __forceinline__ int64_t list_slot(const PathArgs& a, bool front, uint64_t at) {
  return front ? (int64_t)at : a.n_items - 1 - (int64_t)at;
}

// Entry e of the list in the sweep's order: the front, then the back.
__device__ __forceinline__ int64_t list_at(const PathArgs& a, uint64_t n_front, uint64_t e) {
  return a.list[e < n_front ? list_slot(a, true, e) : list_slot(a, false, e - n_front)];
}

// ds_path_adjoint's arguments as a launch's; false where they are not
// valid.  The scratch holds the flights, then the work list.
inline bool path_args(PathArgs* a, const float* dens, const float* insc, int nx, int ny,
                      int nz, const float* eval_rows, int n_phase, const float* inv_rows,
                      int n_inv, const float* entry, const float* dirs, const uint8_t* hit,
                      const int64_t* ray_ids, int64_t n, int64_t r0, int64_t m,
                      const float* consts, const float* ground, int max_steps, int max_depth,
                      int rr_start, int flags, uint32_t seed_base, uint32_t sub_first,
                      int n_samples, const float* g_rec, void* scratch, int max_segments,
                      unsigned long long* counters, float* rec_rad, int32_t* rec_work,
                      double* d_dens, double* d_insc, float* d_entry, float* d_dirs,
                      int32_t* remarch, double* partials) {
  const int64_t n_items = m * (int64_t)n_samples;
  if (max_segments < 1 || r0 < 0 || r0 + m > n || n_items >= ((int64_t)1 << 31)) {
    return false;
  }
  a->dens = dens;
  a->insc = insc;
  a->nx = nx;
  a->ny = ny;
  a->nz = nz;
  a->c = pt_consts(consts, ground, max_steps, max_depth, rr_start, n_phase, n_inv, flags);
  a->gr = diff::grid3(nx, ny, nz, a->c.bbox);
  a->eval_rows = eval_rows;
  a->inv = inv_rows;
  a->entry = entry;
  a->dirs = dirs;
  a->hit = hit;
  a->ray_ids = ray_ids;
  a->n = n;
  a->r0 = r0;
  a->m = m;
  a->n_items = n_items;
  a->seed_base = seed_base;
  a->sub_first = sub_first;
  a->g_rec = g_rec;
  a->seg = (Segment*)scratch;
  a->max_segments = max_segments;
  a->rec_rad = rec_rad;
  a->rec_work = rec_work;
  a->d_dens = d_dens;
  a->d_insc = d_insc;
  a->d_entry = d_entry;
  a->d_dirs = d_dirs;
  a->remarch = remarch;
  a->list = (int64_t*)(a->seg + n_items * (int64_t)max_segments);
  a->counters = counters;
  a->partials = partials;
  return true;
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
// the in-scatter texels (Add; texel k added by the lane k mod lanes of a
// group, gl, so that a group whose lanes all compute this adds each once),
// d s into ds, d w into dw, the light's into L.
template <class Add>
__device__ __forceinline__ void nee_adjoint(const float* __restrict__ insc,
                                            const diff::Grid3& gr,
                                            const float* __restrict__ eval_rows,
                                            const PtConsts& c, const float* s, const float* w,
                                            bool chopped, float weight, const float* gout,
                                            double* d_insc, float* ds, float* dw, LightGrads& L,
                                            int gl, int lanes, const Add& add) {
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
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if ((k & (lanes - 1)) == gl) add(d_insc + tp.idx[k], tbar * tp.w[k]);
  }
  float dp[3];
  diff::taps_point_slope(insc, gr, tp, tbar, dp);
  for (int i = 0; i < 3; ++i) ds[i] += dp[i];
}

// A sample of the sweep: K4's item, its pixel, its seed and stream, and the
// upstream of its record.
struct SweepItem {
  int64_t item, r;
  uint32_t seed, id;
  float gout[3];
};

__device__ __forceinline__ SweepItem sweep_item(const PathArgs& a, int64_t i) {
  SweepItem it;
  it.r = a.r0 + i % a.m;
  const int64_t k = i / a.m;
  it.item = k * a.n + it.r;
  it.seed = sample_seed(a.seed_base, a.sub_first, nullptr, it.r, (uint32_t)k);
  it.id = (uint32_t)a.ray_ids[it.r];
  for (int j = 0; j < 3; ++j) it.gout[j] = a.g_rec[3 * it.item + j];
  return it;
}

// A flight's adjoint but its re-march, for the adjoints (xb, wb) of the
// next flight's start: replaces them by d/d x_d and d/d w_d without the
// re-march's slopes; c0 and cK: the sigma adjoints of steps 1 .. K-1 and K.
// s: the flight's scatter point.  True where the flight is re-marched (an
// in-box scatter with c0 or cK nonzero).  NEE's in-scatter texels as in
// nee_adjoint (gl of `lanes`); the light's gradients into L.
template <class Add>
__device__ __forceinline__ bool flight_head(const PathArgs& a, const Segment& g, const float* s,
                                            const SweepItem& it, float* xb, float* wb,
                                            float& c0, float& cK, LightGrads& L, int gl,
                                            int lanes, const Add& add) {
  const PtConsts& c = a.c;
  const int end = g.info & 3, depth = g.info >> 2;
  float dw[3] = {0.0f, 0.0f, 0.0f};
  c0 = cK = 0.0f;
  if (end != kEndScatter) {
    if ((c.flags & kSky) && end != kEndCut) {
      sky_exit_adjoint(c, g.w, depth, g.weight, it.gout, dw, L.rad);
    }
    for (int j = 0; j < 3; ++j) {
      xb[j] = 0.0f;  // the flight's end is not used
      wb[j] = dw[j];
    }
    return false;
  }
  if (wb[0] != 0.0f || wb[1] != 0.0f || wb[2] != 0.0f) {
    const uint32_t ctr = (uint32_t)depth * 4u;
    new_direction_adjoint(a.inv, c.n_inv, hash_uniform(it.seed, it.id, ctr + 1u),
                          hash_uniform(it.seed, it.id, ctr + 2u), g.w, wb, dw);
  }
  float xs[3] = {xb[0], xb[1], xb[2]};
  const bool chopped = depth != 1 || (c.flags & kChopped1);
  nee_adjoint(a.insc, a.gr, a.eval_rows, c, s, g.w, chopped, g.weight, it.gout, a.d_insc, xs, dw,
              L, gl, lanes, add);
  // s = a_K - w back: d/d x_d = I, d/d w = (K step - back) I, d/d back = -w.
  const float bbar = -((xs[0] * g.w[0] + xs[1] * g.w[1]) + xs[2] * g.w[2]);
  const float dist = (float)g.steps * c.step;
  for (int j = 0; j < 3; ++j) {
    xb[j] = xs[j];
    wb[j] = dw[j] + (xs[j] * dist - xs[j] * g.back);
  }
  const float sig = fmaxf(g.sigma, 1e-10f);
  c0 = g.trans >= 1e-20f ? (bbar * c.step) / sig : 0.0f;
  cK = c0 + (g.sigma >= 1e-10f ? bbar * (-g.back / sig) : 0.0f);
  return c0 != 0.0f || cK != 0.0f;
}

// After the first flight: d/d entry (de) and d/d the pixel's direction (dd)
// from the adjoints (xb, wb) of the first flight's start.
__device__ __forceinline__ void sweep_tail(const PathArgs& a, const SweepItem& it,
                                           const float* xb, const float* wb, float* de,
                                           float* dd) {
  for (int j = 0; j < 3; ++j) {
    de[j] = xb[j];
    dd[j] = 0.0f;
  }
  if (a.c.flags & kResample) {
    // The first direction was redrawn around the pixel's (counters 0, 1).
    if (wb[0] != 0.0f || wb[1] != 0.0f || wb[2] != 0.0f) {
      new_direction_adjoint(a.inv, a.c.n_inv, hash_uniform(it.seed, it.id, 0u),
                            hash_uniform(it.seed, it.id, 1u), a.dirs + 3 * it.r, wb, dd);
    }
  } else {
    for (int j = 0; j < 3; ++j) dd[j] = wb[j];
  }
}

// ---------------------------------------------------------------------------
// The replay and the sweep (the package's kernels; their lane and queue
// parts below, the host build's in tests/torch_kernel_host.cpp).
// ---------------------------------------------------------------------------

// Opens a flight of S: its start, direction and weight.
__device__ __forceinline__ void open_flight(const Sample& S, Segment& g) {
  g.x[0] = S.px;
  g.x[1] = S.py;
  g.x[2] = S.pz;
  g.w[0] = S.dx;
  g.w[1] = S.dy;
  g.w[2] = S.dz;
  g.weight = S.weight;
}

// Starts item i: zeros its d entry, d dirs and re-marched steps, and its
// record where its pixel has no box hit.  True where the sample has steps
// to march; its first flight is then open.
__device__ __forceinline__ bool replay_begin(const PathArgs& a, int64_t i, Sample& S,
                                             int64_t& item) {
  const int64_t r = a.r0 + i % a.m;
  item = (i / a.m) * a.n + r;
  for (int j = 0; j < 3; ++j) {
    a.d_entry[3 * item + j] = 0.0f;
    a.d_dirs[3 * item + j] = 0.0f;
  }
  if (a.remarch != nullptr) a.remarch[item] = 0;
  if (!a.hit[r]) {
    for (int j = 0; j < 3; ++j) a.rec_rad[3 * item + j] = 0.0f;
    a.rec_work[2 * item] = a.rec_work[2 * item + 1] = 0;
    return false;
  }
  if (!begin_item(S, item, a.n, a.entry, a.dirs, a.hit, a.ray_ids, a.inv, a.c, a.seed_base,
                  a.sub_first, nullptr, a.rec_rad, a.rec_work)) {
    return false;
  }
  open_flight(S, a.seg[i * (int64_t)a.max_segments]);
  return true;
}

// Up to K march steps of item i's open flight `flights` (begun at the
// sample's step steps0).  Where the flight ends its record is completed
// (an in-box scatter adds its steps to rsteps, the steps the sweep may
// re-march) and, unless the sample ended, the next flight opened.  True
// where the sample ended.
template <int K>
__device__ __forceinline__ bool replay_chunk(const PathArgs& a, int64_t i, Sample& S,
                                             int& flights, int& steps0, int& rsteps) {
  const PtConsts& c = a.c;
  Crossing X;
  const int state = march_steps<K>(S, X, a.dens, a.nx, a.ny, a.nz, c);
  if (state == kMarching) return false;
  Segment& g = a.seg[i * (int64_t)a.max_segments + flights];
  g.steps = S.steps - steps0;
  const int depth = S.depth;
  bool ended = true;
  if (state == kEnded) {
    // A cap or the depth test leaves the sample in the box; a free step
    // out of the box leaves it outside.
    g.sigma = g.trans = g.back = 0.0f;
    g.info = depth << 2 | (in_box(S.px, S.py, S.pz, c.bbox) ? kEndCut : kEndExit);
  } else {
    const float back = back_distance(S.od, X.tn, X.density);
    const float sx = X.ax - S.dx * back, sy = X.ay - S.dy * back, sz = X.az - S.dz * back;
    g.sigma = X.density;
    g.trans = X.tn;
    g.back = back;
    g.s[0] = sx;
    g.s[1] = sy;
    g.s[2] = sz;
    const bool inb = in_box(sx, sy, sz, c.bbox);
    g.info = depth << 2 | (inb ? kEndScatter : kEndEscape);
    if (inb) rsteps += g.steps;
    ended = resolve(S, X, a.insc, a.nx, a.ny, a.nz, a.eval_rows, a.inv, c);
  }
  ++flights;
  ended = ended || flights >= a.max_segments;
  if (!ended) {
    open_flight(S, a.seg[i * (int64_t)a.max_segments + flights]);
    steps0 = S.steps;
  }
  return ended;
}

// Item `item`'s sample ended: its record.  True where it has an upstream
// (it goes on the sweep's work list).
__device__ __forceinline__ bool replay_end(const PathArgs& a, const Sample& S, int64_t item) {
  write_record(S, item, a.rec_rad, a.rec_work);
  const float* g = a.g_rec + 3 * item;
  return g[0] != 0.0f || g[1] != 0.0f || g[2] != 0.0f;
}

// Lane gl's step of a re-march chunk of G steps of a flight along w of K =
// `steps` steps from step j0, q the position after j0 steps: step j = j0 +
// gl + 1, its position (gl + 1 additions of w step to q, the forward's
// chain) into p and, where j <= K, its texels idx, the values it adds to
// them (the sigma adjoint sb = (j == K ? cK : c0) dm times the weights) in
// v, and its slope's terms summed in float64 into sx and, times j step,
// into sw.  False (v zero) where j > K.
template <int G>
__device__ __forceinline__ bool remarch_lane(const float* __restrict__ dens,
                                             const diff::Grid3& gr, const PtConsts& c,
                                             const float* w, int steps, const float* q, int j0,
                                             int gl, float c0, float cK, float* p, int* idx,
                                             float* v, double* sx, double* sw) {
  p[0] = q[0];
  p[1] = q[1];
  p[2] = q[2];
#pragma unroll
  for (int t = 0; t < G; ++t) {
    if (t <= gl) {
      p[0] = p[0] + w[0] * c.step;
      p[1] = p[1] + w[1] * c.step;
      p[2] = p[2] + w[2] * c.step;
    }
  }
  const int j = j0 + gl + 1;
  if (j > steps) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      idx[k] = 0;
      v[k] = 0.0f;
    }
    return false;
  }
  float u[3];
  diff::unit_coords(gr, p, u);
  const diff::Taps tp = diff::taps_at(gr, u[0], u[1], u[2]);
  const float sb = (j == steps ? cK : c0) * c.dm;  // d trilinear
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    idx[k] = tp.idx[k];
    v[k] = sb * tp.w[k];
  }
  float dp[3];
  diff::taps_point_slope(dens, gr, tp, sb, dp);
  const float dist = (float)j * c.step;
  for (int t = 0; t < 3; ++t) {
    sx[t] += (double)dp[t];
    sw[t] += (double)(dp[t] * dist);
  }
  return true;
}

}  // namespace path
}  // namespace ds

#ifndef DS_HOST_EMULATION

namespace ds {
namespace path {

constexpr unsigned kFull = 0xffffffffu;

// Sums each thread's v[6] over the block into out[6] (thread 0 writes), in
// a fixed order.
__device__ __forceinline__ void block_sum6(double* v, double* out) {
  __shared__ double warp_sums[kThreads / 32][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[j] += __shfl_down_sync(kFull, v[j], off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    for (int j = 0; j < 6; ++j) warp_sums[warp][j] = v[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int j = 0; j < 6; ++j) {
      double acc = 0.0;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) acc += warp_sums[w][j];
      out[j] = acc;
    }
  }
}

// The replay on K4's item queue (pathtrace_items_kernel's refill): each
// lane marches its sample kLookahead steps a warp step; a lane whose sample
// ended takes the next item; the samples with an upstream are appended to
// the work list, one atomicAdd a warp.
__device__ __forceinline__ void replay_items(const PathArgs& a) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  Sample S;
  int64_t i = 0, item = 0;
  int flights = 0, steps0 = 0, rsteps = 0;
  bool have = false, drained = false;
  for (;;) {
    for (;;) {
      const bool need = !have && !drained;
      const unsigned want = __ballot_sync(kFull, need);
      if (want == 0u) break;
      const int leader = __ffs(want) - 1;
      unsigned long long base = 0;
      if (lane == leader) base = atomicAdd(&a.counters[0], (unsigned long long)__popc(want));
      base = __shfl_sync(kFull, base, leader);
      if (need) {
        i = (int64_t)(base + (unsigned long long)__popc(want & below));
        if (i >= a.n_items) {
          drained = true;
        } else {
          have = replay_begin(a, i, S, item);
          flights = steps0 = rsteps = 0;
        }
      }
    }
    if (!__any_sync(kFull, have)) break;
    bool listed = false;
    if (have && replay_chunk<kLookahead>(a, i, S, flights, steps0, rsteps)) {
      have = false;
      listed = replay_end(a, S, item);
    }
    // The list's front (counters[1]) takes the long samples, its back
    // (counters[3]) the others.
    for (int part = 0; part < 2; ++part) {
      const bool mine = listed && (rsteps >= kLongSteps) == (part == 0);
      const unsigned adds = __ballot_sync(kFull, mine);
      if (adds == 0u) continue;
      const int leader = __ffs(adds) - 1;
      unsigned long long base = 0;
      if (lane == leader) {
        base = atomicAdd(&a.counters[part == 0 ? 1 : 3], (unsigned long long)__popc(adds));
      }
      base = __shfl_sync(kFull, base, leader);
      if (mine) {
        a.list[list_slot(a, part == 0, base + __popc(adds & below))] = list_entry(i, flights);
      }
    }
  }
}

// List entry e's sample swept by its group of G lanes (sweep's order and
// flight_head's values; each flight re-marched in chunks of G steps, lane
// gl on step c G + gl + 1 of chunk c, the runs of lanes in one cell merged
// by group_deposit).  Lane 0 writes d entry, d dirs and the re-marched
// steps and adds the light's gradients to acc.
template <int G, class Add>
__device__ __forceinline__ void sweep_entry(const PathArgs& a, const GroupLanes& gr,
                                            int64_t e, double* acc, const Add& add) {
  const int64_t i = e >> 32;
  const int flights = (int)(e & 0xffffffff);
  const SweepItem it = sweep_item(a, i);
  const Segment* seg = a.seg + i * (int64_t)a.max_segments;
  float xb[3] = {0.0f, 0.0f, 0.0f}, wb[3] = {0.0f, 0.0f, 0.0f};
  LightGrads L = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  int remarched = 0;
  for (int d = flights - 1; d >= 0; --d) {
    const Segment g = seg[d];
    float c0, cK;
    if (!flight_head(a, g, g.s, it, xb, wb, c0, cK, L, gr.gl, G, add)) continue;
    remarched += g.steps;
    double sx[3] = {0.0, 0.0, 0.0}, sw[3] = {0.0, 0.0, 0.0};
    float q[3] = {g.x[0], g.x[1], g.x[2]};
    for (int j0 = 0; j0 < g.steps; j0 += G) {
      float p[3], v[8];
      int idx[8];
      const bool on =
          remarch_lane<G>(a.dens, a.gr, a.c, g.w, g.steps, q, j0, gr.gl, c0, cK, p, idx, v, sx,
                          sw);
      group_deposit<G>(gr.mask, gr.gl, gr.shift, on ? idx[0] : -1 - gr.gl, idx, v, a.d_dens, add);
      for (int t = 0; t < 3; ++t) q[t] = __shfl_sync(gr.mask, p[t], G - 1, G);
    }
    group_sum3<G>(gr, sx);
    group_sum3<G>(gr, sw);
    for (int t = 0; t < 3; ++t) {
      xb[t] += (float)__shfl_sync(gr.mask, sx[t], 0, G);
      wb[t] += (float)__shfl_sync(gr.mask, sw[t], 0, G);
    }
  }
  if (gr.gl != 0) return;
  float de[3], dd[3];
  sweep_tail(a, it, xb, wb, de, dd);
  for (int j = 0; j < 3; ++j) {
    a.d_entry[3 * it.item + j] = de[j];
    a.d_dirs[3 * it.item + j] = dd[j];
    acc[j] += (double)L.dir[j];
    acc[3 + j] += (double)L.rad[j];
  }
  if (a.remarch != nullptr) a.remarch[it.item] = remarched;
}

// The sweep, G lanes a list entry (the list's front, then its back), on a
// persistent grid whose groups take the entries one at a time from a
// queue (counters[2]).  partials[6 * block]: the block's light gradients.
template <int G, class Add>
__device__ __forceinline__ void sweep_items(const PathArgs& a, const Add& add) {
  const GroupLanes gr = group_lanes<G>();
  const unsigned long long n_front = a.counters[1], len = n_front + a.counters[3];
  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (;;) {
    unsigned long long e = 0;
    if (gr.gl == 0) e = atomicAdd(&a.counters[2], 1ull);
    e = __shfl_sync(gr.mask, e, 0, G);
    if (e >= len) break;
    sweep_entry<G>(a, gr, list_at(a, n_front, e), acc, add);
  }
  block_sum6(acc, a.partials + 6 * (int64_t)blockIdx.x);
}

}  // namespace path
}  // namespace ds

__global__ void __launch_bounds__(ds::path::kThreads, ds::path::kReplayBlocks) path_replay_kernel(
    ds::path::PathArgs a) {
  ds::path::replay_items(a);
}

__global__ void __launch_bounds__(ds::path::kThreads, ds::path::kSweepBlocks) path_sweep_kernel(
    ds::path::PathArgs a) {
  ds::path::sweep_items<ds::path::kSweepLanes>(a, ds::diff::AddTo());
}

// Blocks of `kernel` that fill the card once (occupancy x SMs; *per_sm
// caches the occupancy), at most `needed`.
template <typename F>
static int card_blocks(F kernel, int* per_sm, int64_t needed, unsigned* blocks) {
  if (*per_sm == 0) {
    int b = 0;
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, ds::path::kThreads, 0);
    if (e != cudaSuccess) return (int)e;
    *per_sm = b > 0 ? b : 1;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int64_t full = (int64_t)*per_sm * sms;
  *blocks = (unsigned)(needed < full ? needed : full);
  return 0;
}

// The replay's blocks for a launch of n_items items: a thread an item, at
// most the card's resident blocks of `kernel`.
template <typename F>
static int replay_grid(F kernel, int* per_sm, int64_t n_items, unsigned* blocks) {
  return card_blocks(kernel, per_sm, (n_items + ds::path::kThreads - 1) / ds::path::kThreads,
                     blocks);
}

// The blocks (and partial rows) of a sweep of `lanes` lanes a sample for
// a launch of n_items items: a group an item, at most the card's resident
// blocks of `kernel`.
template <typename F>
static int sweep_grid(F kernel, int lanes, int* per_sm, int64_t n_items, unsigned* blocks) {
  const int64_t needed = (n_items * lanes + ds::path::kThreads - 1) / ds::path::kThreads;
  return card_blocks(kernel, per_sm, needed, blocks);
}

static int sweep_blocks(int64_t n_items, unsigned* blocks) {
  static int per_sm = 0;
  return sweep_grid(path_sweep_kernel, ds::path::kSweepLanes, &per_sm, n_items, blocks);
}

// A kernel's registers a thread, or -1.
template <typename F>
static int kernel_registers(F kernel) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return -1;
  return attr.numRegs;
}

extern "C" {

// The scratch bytes a pixel of n_samples samples takes: its flights
// (max_segments a sample) and its work-list entries.
int64_t ds_path_pixel_bytes(int n_samples, int max_segments) {
  return ds::path::pixel_bytes(n_samples, max_segments);
}

// The partial rows of a launch of m pixels x n_samples (the sweep's
// blocks), or -1.
int64_t ds_path_adjoint_blocks(int64_t m, int n_samples) {
  unsigned blocks = 0;
  if (sweep_blocks(m * (int64_t)n_samples, &blocks) != 0) return -1;
  return blocks;
}

// K8c over pixels r0 .. r0 + m - 1 of n: the replay, then the sweep.  The
// scene arguments (float32 textures), consts, ground, max_steps,
// max_depth, rr_start, flags, seed_base, sub_first and n_samples are
// ds_pathtrace's.  g_rec: the upstream of the records, [n_samples][n][3];
// scratch: m x ds_path_pixel_bytes (the flights, then the work list);
// counters: 4 uint64, zeroed here (the replay's queue head, the work
// list's length, the sweep's queue head); rec_rad [n_samples][n][3] and
// rec_work [n_samples][n][2]: the replayed records (zeros where a pixel has
// no hit); d_dens, d_insc: float64 grids, zeroed by the caller and added
// to; d_entry, d_dirs: [n_samples][n][3]; remarch: NULL or [n_samples][n]
// int32, the steps each sample's adjoint re-marched; partials: float64
// [ds_path_adjoint_blocks(m, n_samples)][6] (light_dir's and
// light_radiance's gradients a block).
int ds_path_adjoint(const float* dens, const float* insc, int nx, int ny, int nz,
                    const float* eval_rows, int n_phase, const float* inv_rows, int n_inv,
                    const float* entry, const float* dirs, const uint8_t* hit,
                    const int64_t* ray_ids, int64_t n, int64_t r0, int64_t m,
                    const float* consts, const float* ground, int max_steps, int max_depth,
                    int rr_start, int flags, uint32_t seed_base, uint32_t sub_first,
                    int n_samples, const float* g_rec, void* scratch, int max_segments,
                    unsigned long long* counters, float* rec_rad, int32_t* rec_work,
                    double* d_dens, double* d_insc, float* d_entry, float* d_dirs,
                    int32_t* remarch, double* partials, void* stream) {
  if (m * (int64_t)n_samples <= 0) return 0;
  ds::path::PathArgs a;
  if (!ds::path::path_args(&a, dens, insc, nx, ny, nz, eval_rows, n_phase, inv_rows, n_inv,
                           entry, dirs, hit, ray_ids, n, r0, m, consts, ground, max_steps,
                           max_depth, rr_start, flags, seed_base, sub_first, n_samples, g_rec,
                           scratch, max_segments, counters, rec_rad, rec_work, d_dens, d_insc,
                           d_entry, d_dirs, remarch, partials)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  int err = (int)cudaMemsetAsync(a.counters, 0, 4 * sizeof(unsigned long long), s);
  if (err != 0) return err;
  static int per_sm = 0;
  unsigned blocks = 0;
  err = replay_grid(path_replay_kernel, &per_sm, a.n_items, &blocks);
  if (err != 0) return err;
  path_replay_kernel<<<blocks, ds::path::kThreads, 0, s>>>(a);
  err = (int)cudaGetLastError();
  if (err == 0) err = sweep_blocks(a.n_items, &blocks);
  if (err != 0) return err;
  path_sweep_kernel<<<blocks, ds::path::kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// The sweep's lanes a sample.
int ds_path_lanes() { return ds::path::kSweepLanes; }

// The registers a thread of the replay (kernel 0) or the sweep (1) takes,
// or -1.
int ds_path_registers(int kernel) {
  return kernel == 0 ? kernel_registers(path_replay_kernel)
                     : kernel_registers(path_sweep_kernel);
}

}  // extern "C"

#endif  // DS_HOST_EMULATION
