// K8a and K8b: the kernels of the differentiable single-scatter renderer
// (render/diff.py), each the adjoint, or the forward and the adjoint, of a
// loop that the JAX package leaves to XLA's reverse mode:
//
//   K8a  ds_bake_adjoint: the adjoint of deepestscatter_tpu/render/diff.py::
//        bake_inscatter_diff (lines 270-309).  Its forward is K3
//        (csrc/inscatter.cu::ds_bake with early_out = 0: the same positions
//        base + to_light * (step * i), the same taps, T *= exp(-sigma step)).
//   K8b  ds_diff_march / ds_diff_march_bwd: the quadrature march of
//        render_single_scatter (diff.py:198-238) and its adjoint, one thread
//        a ray; ds_sun_march / ds_sun_march_bwd: the per-point sun march
//        sun_transmittance (diff.py:64-88) and its adjoint, one thread a
//        point.  The same sun march is the quadrature's pointwise in-scatter.
//
// Neither adjoint stores the march.  XLA's reverse mode keeps a float a
// voxel a step (the bake) or a carry a ray a step (the march) and
// recomputes the forward under jax.checkpoint; these kernels replay the
// forward in its own order and with its own expressions instead:
//
//   - the bake: T_v = exp(-step * sum_k sigma_k), so dT_v / dsigma_k =
//     -step * T_v at every step k.  A voxel with an upstream gradient g_v
//     replays its march and adds -step * dm * T_v * g_v * w to the density
//     texels under each step's trilinear weights w (atomicAdd; a voxel with
//     g_v == 0 adds exactly nothing and is skipped), and sums the slope of
//     the sample along the march, times the step's distance, into the light
//     direction's gradient (reduced per block into a partial row; the
//     wrapper sums the rows, so the light gradient is deterministic).
//   - the march: R = sum_k c_k with c_k = T_view(k) seg_k S_k p r.  The view
//     transmittance of step k carries every earlier sigma_j (j < k), so
//     dR / dsigma_j through it is -step * sum_{k > j} c_k = -step * (R - C_j)
//     with C_j the running prefix sum, R the forward's saved radiance: a
//     replay in step order gives every gradient.  The other terms of
//     dR / dsigma_j are the segment weight's (step * exp(-sigma step)) and
//     the free-flight mean point's (its slope in sigma, times the in-scatter
//     field's slope along the ray).  The in-scatter is a trilinear tap of
//     the baked grid (its adjoint: atomicAdd into the baked grid's gradient,
//     which K8a then takes as g) or the pointwise sun march (its adjoint
//     replays the sun march: atomicAdd into the density gradient, the slope
//     times the distance into the sun direction's gradient).
//
// Every expression of the forward is the plain version's (render/diff.py),
// in its order; the kernels are compiled with -fmad=false, so the forwards
// equal their plain versions bitwise on the card where both call the same
// expf / expm1f.  The adjoints sum in another order than autograd does, and
// with atomics in an order that changes from run to run.
//
// Bounds on the card: both are operation-bound.  K8a does ~100 operations a
// voxel-step (the sample's cell, weights and eight taps for the slope,
// eight weighted atomic adds, the light gradient) and moves 16 bytes a
// voxel; K8b's forward ~220 a ray-step with sigma != 0 in baked mode (two
// trilinear samples, three exponentials, the mean point) and ~95 a step
// with sigma == 0 (the density sample and tau), its backward ~480 and ~290
// (no baked-grid scatter, no mean-point slope where sigma == 0).
// chip_smoke.py counts the steps this run's data needs (a ray stops at the
// box exit, after which every term is an exact 0; a bake voxel with g == 0
// does no step), from the counts ds_diff_march and ds_sun_march report.
//
// The design: a thread a voxel (K8a) or a ray (K8b), scattering by
// atomicAdd into device memory.  K8a's first form, eight atomics a
// voxel-step, spent seconds at chip_smoke.py's frame point (256^3 cumulus,
// 889 steps, 2.6 M voxels with a gradient) on the box's face texels, and
// lost the density gradient there in float32 (every march that
// leaves the box adds its clamped samples to a face texel, against float64
// sums).  It now sums in float64 and merges its atomics along runs of steps
// that read the same texels (bake_adjoint_voxel).  A gather for K8a
// (for a fixed step every voxel's sample is the same translate, so
// d/d density is a transposed 2x2x2 stencil summed over the steps, clamped
// at the faces) would be deterministic and free of atomics: the candidate
// for its next redesign.
#include "common.cuh"

namespace ds {
namespace diff {

// Threads a block of every diff kernel; ds_bake_adjoint writes one row of
// light-gradient partials a block.
constexpr int kDiffThreads = 128;

// *p += v: an atomicAdd on the card, a plain add in the host build.  A
// zero adds nothing and is skipped.
template <typename G>
__device__ __forceinline__ void add_to(G* p, float v) {
  if (v == 0.0f) return;
#ifdef DS_HOST_EMULATION
  *p += (G)v;
#else
  atomicAdd(p, (G)v);
#endif
}

struct Grid3 {
  int nx, ny, nz;
  float bbox[3];
  float inv_bbox[3];  // pow2_recip(bbox): coordinates as products
};

inline Grid3 grid3(int nx, int ny, int nz, const float* bbox) {
  Grid3 g;
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  for (int i = 0; i < 3; ++i) {
    g.bbox[i] = bbox[i];
    g.inv_bbox[i] = pow2_recip(bbox[i]);
  }
  return g;
}

// The eight taps of a trilinear sample (common.cuh::trilinear's cells,
// weights (wz * wy) * wx and corner order), with the slopes of the three
// fractions in u: n where floor(t) >= 0, else 0 (the fraction is pinned to
// 0 there).
struct Taps {
  int idx[8];
  float w[8];
  float wx[2], wy[2], wz[2];
  float sx, sy, sz;
};

__device__ __forceinline__ Taps taps_at(const Grid3& g, float ux, float uy, float uz) {
  const float tx = ux * (float)g.nx - 0.5f;
  const float ty = uy * (float)g.ny - 0.5f;
  const float tz = uz * (float)g.nz - 0.5f;
  const AxisCell cx = axis_cell(tx, g.nx);
  const AxisCell cy = axis_cell(ty, g.ny);
  const AxisCell cz = axis_cell(tz, g.nz);
  Taps t;
  t.wx[0] = 1.0f - cx.frac;
  t.wx[1] = cx.frac;
  t.wy[0] = 1.0f - cy.frac;
  t.wy[1] = cy.frac;
  t.wz[0] = 1.0f - cz.frac;
  t.wz[1] = cz.frac;
  t.sx = floorf(tx) < 0.0f ? 0.0f : (float)g.nx;
  t.sy = floorf(ty) < 0.0f ? 0.0f : (float)g.ny;
  t.sz = floorf(tz) < 0.0f ? 0.0f : (float)g.nz;
  const int xs[2] = {cx.i0, cx.i1};
  const int ys[2] = {cy.i0, cy.i1};
  const int zs[2] = {cz.i0, cz.i1};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ix = k & 1, iy = (k >> 1) & 1, iz = k >> 2;
    t.idx[k] = (zs[iz] * g.ny + ys[iy]) * g.nx + xs[ix];
    t.w[k] = (t.wz[iz] * t.wy[iy]) * t.wx[ix];
  }
  return t;
}

__device__ __forceinline__ float taps_value(const float* __restrict__ grid, const Taps& t) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float term = grid[t.idx[k]] * t.w[k];
    acc = k == 0 ? term : acc + term;
  }
  return acc;
}

// d sample / d u along x, y and z.
__device__ __forceinline__ void taps_slope(const float* __restrict__ grid, const Taps& t,
                                           float* du) {
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ix = k & 1, iy = (k >> 1) & 1, iz = k >> 2;
    const float v = grid[t.idx[k]];
    const float ax = v * (t.wz[iz] * t.wy[iy]);
    const float ay = v * (t.wz[iz] * t.wx[ix]);
    const float az = v * (t.wy[iy] * t.wx[ix]);
    gx = ix ? gx + ax : gx - ax;
    gy = iy ? gy + ay : gy - ay;
    gz = iz ? gz + az : gz - az;
  }
  du[0] = gx * t.sx;
  du[1] = gy * t.sy;
  du[2] = gz * t.sz;
}

// Adds s * w_k to the eight texels, and returns d (s * sample) / d p.
template <typename G>
__device__ __forceinline__ void taps_adjoint(const float* __restrict__ grid, const Grid3& g,
                                             const Taps& t, float s, G* d_grid, float* dp) {
#pragma unroll
  for (int k = 0; k < 8; ++k) add_to(d_grid + t.idx[k], s * t.w[k]);
  float du[3];
  taps_slope(grid, t, du);
#pragma unroll
  for (int a = 0; a < 3; ++a) dp[a] = div_exact(s * du[a], g.bbox[a], g.inv_bbox[a]);
}

__device__ __forceinline__ void unit_coords(const Grid3& g, const float* p, float* u) {
#pragma unroll
  for (int a = 0; a < 3; ++a) u[a] = div_exact(p[a], g.bbox[a], g.inv_bbox[a]);
}

// diff.py::sample_density's mask: u in [0, 1] on every axis.
__device__ __forceinline__ bool inside_unit(const float* u) {
  return u[0] >= 0.0f && u[0] <= 1.0f && u[1] >= 0.0f && u[1] <= 1.0f && u[2] >= 0.0f &&
         u[2] <= 1.0f;
}

// ---------------------------------------------------------------------------
// The sun march: T = exp(-tau), tau += sigma(q + to_sun * step (j + 1)) step.
// A straight line leaves the box once (each coordinate is monotone in j,
// rounding included), and after it every sigma is 0 and tau unchanged: the
// march stops there.  *n_in: the samples taken in the box.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float sun_march(const float* __restrict__ dens, const Grid3& g,
                                           float step, float dm, int n, const float* q,
                                           const float* ts, int* n_in) {
  float tau = 0.0f;
  bool was_in = false;
  *n_in = 0;
  for (int j = 0; j < n; ++j) {
    const float s = step * (float)(j + 1);
    const float p[3] = {q[0] + ts[0] * s, q[1] + ts[1] * s, q[2] + ts[2] * s};
    float u[3];
    unit_coords(g, p, u);
    if (!inside_unit(u)) {
      if (was_in) break;
      continue;
    }
    was_in = true;
    ++*n_in;
    const float sigma = taps_value(dens, taps_at(g, u[0], u[1], u[2])) * dm;
    tau = tau + sigma * step;
  }
  return expf(-tau);
}

// The sun march's adjoint for upstream gT at T: density texels by atomics,
// d/dq into dq and d/d to_sun into dts (both added to).
__device__ __forceinline__ void sun_march_adjoint(const float* __restrict__ dens,
                                                  const Grid3& g, float step, float dm, int n,
                                                  const float* q, const float* ts, float T,
                                                  float gT, float* d_dens, float* dq,
                                                  float* dts) {
  // dtau = -gT T; dsigma_j = dtau step; d sample_j = dsigma_j dm.
  const float drho = ((-(gT * T)) * step) * dm;
  if (drho == 0.0f) return;
  bool was_in = false;
  for (int j = 0; j < n; ++j) {
    const float s = step * (float)(j + 1);
    const float p[3] = {q[0] + ts[0] * s, q[1] + ts[1] * s, q[2] + ts[2] * s};
    float u[3];
    unit_coords(g, p, u);
    if (!inside_unit(u)) {
      if (was_in) break;
      continue;
    }
    was_in = true;
    float dp[3];
    taps_adjoint(dens, g, taps_at(g, u[0], u[1], u[2]), drho, d_dens, dp);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      dq[a] += dp[a];
      dts[a] += dp[a] * s;
    }
  }
}

// ---------------------------------------------------------------------------
// The quadrature march (K8b).
// ---------------------------------------------------------------------------

struct MarchConsts {
  Grid3 g;
  float step, dm, sun_ratio;
  int n_steps, sun_steps;
  int baked;  // 1: t_sun from the baked grid; 0: the sun march
};

// consts: bbox[3], step, dm, sun_ratio (host floats).
inline MarchConsts march_consts(int nx, int ny, int nz, const float* k, int n_steps,
                                int sun_steps, int baked) {
  MarchConsts c;
  c.g = grid3(nx, ny, nz, k);
  c.step = k[3];
  c.dm = k[4];
  c.sun_ratio = k[5];
  c.n_steps = n_steps;
  c.sun_steps = sun_steps;
  c.baked = baked;
  return c;
}

// One step's values up to the NEE point.
struct Step {
  float s;
  Taps tp;  // the density's taps at p
  float sigma, tv, e1, seg;
  float sig, a, em, ea, mean_x;
  bool taylor;
  float q[3];  // the NEE point
};

// Step i of the ray (entry e, direction d) at optical depth tau; false
// where the sample lies outside the box (sigma = 0 there, an exact 0 term).
__device__ __forceinline__ bool step_at(const float* __restrict__ dens, const MarchConsts& c,
                                        const float* e, const float* d, int i, float tau,
                                        Step& st) {
  st.s = c.step * (float)(i + 1);
  const float p[3] = {e[0] + d[0] * st.s, e[1] + d[1] * st.s, e[2] + d[2] * st.s};
  float u[3];
  unit_coords(c.g, p, u);
  if (!inside_unit(u)) return false;
  st.tp = taps_at(c.g, u[0], u[1], u[2]);
  st.sigma = taps_value(dens, st.tp) * c.dm;
  st.tv = expf(-tau);
  st.e1 = expf(-st.sigma * c.step);
  st.seg = 1.0f - st.e1;
  // The free-flight mean point within the segment, diff.py:217-223.
  st.sig = fmaxf(st.sigma, 1e-6f);
  st.a = st.sig * c.step;
  st.em = -expm1f(-st.a);
  st.ea = expf(-st.a);
  st.taylor = st.a < 1e-3f;
  st.mean_x = st.taylor ? c.step * (0.5f - st.a / 12.0f)
                        : 1.0f / st.sig - c.step * st.ea / fmaxf(st.em, 1e-30f);
  const float back = c.step - st.mean_x;
#pragma unroll
  for (int a = 0; a < 3; ++a) st.q[a] = p[a] - d[a] * back;
  return true;
}

// d mean_x / d sigma where sigma > 1e-6 (the chosen branch's).
__device__ __forceinline__ float mean_x_slope(const Step& st, float step) {
  if (st.taylor) return -((step / 12.0f) * step);
  const float r = 1.0f / st.sig;
  const float D = fmaxf(st.em, 1e-30f);
  float out = -(r * r) + ((step * step) * st.ea) / D;
  if (st.em > 1e-30f) out = out + ((step * step) * (st.ea * st.ea)) / (D * D);
  return out;
}

// The in-scatter at q: the baked grid's trilinear tap (taps into *tq), or
// the sun march.
__device__ __forceinline__ float t_sun_at(const float* __restrict__ dens,
                                          const float* __restrict__ baked,
                                          const MarchConsts& c, const float* ts, const float* q,
                                          Taps* tq) {
  if (c.baked) {
    float u[3];
    unit_coords(c.g, q, u);
    *tq = taps_at(c.g, u[0], u[1], u[2]);
    return taps_value(baked, *tq);
  }
  int n_in;
  return sun_march(dens, c.g, c.step, c.dm, c.sun_steps, q, ts, &n_in);
}

// A ray's radiance sum; counts[0] its steps in the box, counts[1] those
// with sigma != 0 (where the in-scatter is read).
__device__ __forceinline__ float march_ray(const float* __restrict__ dens,
                                           const float* __restrict__ baked,
                                           const MarchConsts& c, const float* ts,
                                           const float* e, const float* d, float phase,
                                           int* counts) {
  float tau = 0.0f, rad = 0.0f;
  bool was_in = false;
  int n_in = 0, n_lit = 0;
  for (int i = 0; i < c.n_steps; ++i) {
    Step st;
    if (!step_at(dens, c, e, d, i, tau, st)) {
      if (was_in) break;
      continue;
    }
    was_in = true;
    ++n_in;
    // sigma == 0: seg == 0, the term is an exact 0.
    if (st.sigma != 0.0f) {
      ++n_lit;
      Taps tq;
      const float S = t_sun_at(dens, baked, c, ts, st.q, &tq);
      rad = rad + (((st.tv * st.seg) * S) * phase) * c.sun_ratio;
    }
    tau = tau + st.sigma * c.step;
  }
  counts[0] = n_in;
  counts[1] = n_lit;
  return rad;
}

// The ray's adjoint for upstream g at the forward's radiance R: density
// (and baked-grid) texels by atomics; d/d entry, d/d dirs, d/d to_sun
// (pointwise) added to de, dd, dts; returns d/d phase.
__device__ __forceinline__ float march_ray_adjoint(
    const float* __restrict__ dens, const float* __restrict__ baked, const MarchConsts& c,
    const float* ts, const float* e, const float* d, float phase, float R, float g,
    float* d_dens, float* d_baked, float* de, float* dd, float* dts) {
  float tau = 0.0f, C = 0.0f, dP = 0.0f;
  bool was_in = false;
  for (int i = 0; i < c.n_steps; ++i) {
    Step st;
    if (!step_at(dens, c, e, d, i, tau, st)) {
      if (was_in) break;
      continue;
    }
    was_in = true;
    Taps tq;
    const float S = t_sun_at(dens, baked, c, ts, st.q, &tq);
    const float tvseg = st.tv * st.seg;
    C = C + ((tvseg * S) * phase) * c.sun_ratio;  // the prefix through this step
    dP = dP + (tvseg * S) * c.sun_ratio;
    // Through the later steps' view transmittance, and the segment weight.
    float dsigma = g * ((-c.step) * (R - C)) +
                   g * ((((st.tv * (st.e1 * c.step)) * S) * phase) * c.sun_ratio);
    const float dS = ((tvseg * phase) * c.sun_ratio) * g;
    float dp[3] = {0.0f, 0.0f, 0.0f};
    if (dS != 0.0f) {
      float dq[3] = {0.0f, 0.0f, 0.0f};
      if (c.baked) {
        taps_adjoint(baked, c.g, tq, dS, d_baked, dq);
      } else {
        sun_march_adjoint(dens, c.g, c.step, c.dm, c.sun_steps, st.q, ts, S, dS, d_dens, dq,
                          dts);
      }
      // q = p - d (step - mean_x).
      const float back = c.step - st.mean_x;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        dp[a] += dq[a];
        dd[a] += dq[a] * (-back);
      }
      if (st.sigma > 1e-6f) {  // sig = max(sigma, 1e-6)
        const float dmean = (dq[0] * d[0] + dq[1] * d[1]) + dq[2] * d[2];
        dsigma = dsigma + dmean * mean_x_slope(st, c.step);
      }
    }
    float dps[3];
    taps_adjoint(dens, c.g, st.tp, dsigma * c.dm, d_dens, dps);
    // p = e + d s.
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float t = dp[a] + dps[a];
      de[a] += t;
      dd[a] += t * st.s;
    }
    tau = tau + st.sigma * c.step;
  }
  return dP * g;
}

// ---------------------------------------------------------------------------
// The bake's adjoint (K8a).
// ---------------------------------------------------------------------------

struct AdjConsts {
  Grid3 g;
  float light[3];  // light_dir; the march goes along -light_dir
  float step, dm, max_dim;
};

// consts: bbox[3], light_dir[3], step, dm, max_dim (ds_bake's).
inline AdjConsts adj_consts(int nx, int ny, int nz, const float* k) {
  AdjConsts c;
  c.g = grid3(nx, ny, nz, k);
  for (int i = 0; i < 3; ++i) c.light[i] = k[3 + i];
  c.step = k[6];
  c.dm = k[7];
  c.max_dim = k[8];
  return c;
}

// Voxel v's replay: density texels by atomics, d/d light_dir added to dl.
// The density gradient is summed in float64: a texel on the box's faces
// takes the clamped samples of every march that leaves the box across it,
// ~10^5 terms at 256^3, which a float32 sum rounds to ~1e-3 (0.57 of the
// largest value at the frame point with float32 atomics).  The taps of
// consecutive steps often coincide (a cell spans about two steps at a step
// of half a voxel; outside the box a clamped axis keeps its texel), so the
// replay merges a clamped axis's two taps (one texel), sums each texel's
// weights in registers while the step's texels are the last step's, and
// adds drho times the sums once they change (and at the end).
__device__ __forceinline__ void bake_adjoint_voxel(int64_t v, const float* __restrict__ dens,
                                                   const AdjConsts& c, int n_steps, float T,
                                                   float gbar, double* d_dens, float* dl) {
  if (gbar == 0.0f) return;
  const int x = (int)(v % c.g.nx);
  const int y = (int)((v / c.g.nx) % c.g.ny);
  const int z = (int)(v / ((int64_t)c.g.nx * c.g.ny));
  const float b[3] = {(float)x / c.max_dim, (float)y / c.max_dim, (float)z / c.max_dim};
  const float lx = -c.light[0], ly = -c.light[1], lz = -c.light[2];
  // dT / dsigma_k = -step T at every step; d sample_k = dsigma_k dm.
  const float drho = ((-(gbar * T)) * c.step) * c.dm;
  if (drho == 0.0f) return;
  int key = -1;         // the run's first texel, -1 before the first step
  unsigned merged = 0u;  // its clamped axes (bits x, y, z)
  int run_idx[8];
  float run_w[8];
  int n_run = 0;
  for (int i = 0; i < n_steps; ++i) {
    const float s = c.step * (float)i;
    const float p[3] = {b[0] + lx * s, b[1] + ly * s, b[2] + lz * s};
    float u[3];
    unit_coords(c.g, p, u);
    const Taps t = taps_at(c.g, u[0], u[1], u[2]);
    float du[3];
    taps_slope(dens, t, du);
    // p = base + (-light) s.
#pragma unroll
    for (int a = 0; a < 3; ++a) dl[a] -= div_exact(drho * du[a], c.g.bbox[a], c.g.inv_bbox[a]) * s;
    const bool cx = t.idx[0] == t.idx[1], cy = t.idx[0] == t.idx[2], cz = t.idx[0] == t.idx[4];
    const unsigned flags = (cx ? 1u : 0u) | (cy ? 2u : 0u) | (cz ? 4u : 0u);
    const float wx[2] = {cx ? t.wx[0] + t.wx[1] : t.wx[0], t.wx[1]};
    const float wy[2] = {cy ? t.wy[0] + t.wy[1] : t.wy[0], t.wy[1]};
    const float wz[2] = {cz ? t.wz[0] + t.wz[1] : t.wz[0], t.wz[1]};
    const int mx = cx ? 1 : 2, my = cy ? 1 : 2, mz = cz ? 1 : 2;
    const bool same = t.idx[0] == key && flags == merged;
    if (!same) {
      for (int j = 0; j < n_run; ++j) add_to(d_dens + run_idx[j], drho * run_w[j]);
      key = t.idx[0];
      merged = flags;
    }
    int j = 0;
    for (int iz = 0; iz < mz; ++iz) {
      for (int iy = 0; iy < my; ++iy) {
        for (int ix = 0; ix < mx; ++ix, ++j) {
          const float w = (wz[iz] * wy[iy]) * wx[ix];
          if (same) {
            run_w[j] += w;
          } else {
            run_idx[j] = t.idx[ix + 2 * iy + 4 * iz];
            run_w[j] = w;
          }
        }
      }
    }
    n_run = j;
  }
  for (int j = 0; j < n_run; ++j) add_to(d_dens + run_idx[j], drho * run_w[j]);
}

}  // namespace diff
}  // namespace ds

#ifndef DS_HOST_EMULATION

using ds::diff::kDiffThreads;

// Sums each thread's v[3] over the block into out[3] (thread 0 writes), in
// a fixed order.
__device__ __forceinline__ void block_sum3(float* v, float* out) {
  __shared__ float warp_sums[kDiffThreads / 32][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[a] += __shfl_down_sync(0xffffffffu, v[a], off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    for (int a = 0; a < 3; ++a) warp_sums[warp][a] = v[a];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int a = 0; a < 3; ++a) {
      float acc = 0.0f;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) acc += warp_sums[w][a];
      out[a] = acc;
    }
  }
}

__global__ void __launch_bounds__(kDiffThreads) bake_adjoint_kernel(
    const float* __restrict__ dens, ds::diff::AdjConsts c, int n_steps, const float* __restrict__ trans,
    const float* __restrict__ gbar, double* d_dens, float* partials, int64_t n) {
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float dl[3] = {0.0f, 0.0f, 0.0f};
  if (v < n) ds::diff::bake_adjoint_voxel(v, dens, c, n_steps, trans[v], gbar[v], d_dens, dl);
  block_sum3(dl, partials + 3 * (int64_t)blockIdx.x);
}

__device__ __forceinline__ void load3(const float* p, int64_t r, float* out) {
  out[0] = p[3 * r];
  out[1] = p[3 * r + 1];
  out[2] = p[3 * r + 2];
}

__global__ void __launch_bounds__(kDiffThreads) march_kernel(
    const float* __restrict__ dens, const float* __restrict__ baked,
    const float* __restrict__ to_sun, ds::diff::MarchConsts c, const float* __restrict__ entry,
    const float* __restrict__ dirs, const float* __restrict__ phase,
    const uint8_t* __restrict__ hit, int64_t n, float* rad, int* steps) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  int counts[2] = {0, 0};
  float out = 0.0f;
  if (hit[r]) {
    float ts[3] = {0.0f, 0.0f, 0.0f}, e[3], d[3];
    if (!c.baked) load3(to_sun, 0, ts);
    load3(entry, r, e);
    load3(dirs, r, d);
    out = ds::diff::march_ray(dens, baked, c, ts, e, d, phase[r], counts);
  }
  rad[r] = out;
  if (steps != nullptr) {
    steps[2 * r] = counts[0];
    steps[2 * r + 1] = counts[1];
  }
}

__global__ void __launch_bounds__(kDiffThreads) march_bwd_kernel(
    const float* __restrict__ dens, const float* __restrict__ baked,
    const float* __restrict__ to_sun, ds::diff::MarchConsts c, const float* __restrict__ entry,
    const float* __restrict__ dirs, const float* __restrict__ phase,
    const uint8_t* __restrict__ hit, const float* __restrict__ rad,
    const float* __restrict__ g_rad, int64_t n, float* d_dens, float* d_baked, float* d_entry,
    float* d_dirs, float* d_phase, float* d_ts) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float de[3] = {0.0f, 0.0f, 0.0f}, dd[3] = {0.0f, 0.0f, 0.0f}, dts[3] = {0.0f, 0.0f, 0.0f};
  float dphase = 0.0f;
  const float g = g_rad[r];
  if (hit[r] && g != 0.0f) {
    float ts[3] = {0.0f, 0.0f, 0.0f}, e[3], d[3];
    if (!c.baked) load3(to_sun, 0, ts);
    load3(entry, r, e);
    load3(dirs, r, d);
    dphase = ds::diff::march_ray_adjoint(dens, baked, c, ts, e, d, phase[r], rad[r], g, d_dens,
                                   d_baked, de, dd, dts);
  }
  for (int a = 0; a < 3; ++a) {
    d_entry[3 * r + a] = de[a];
    d_dirs[3 * r + a] = dd[a];
    if (d_ts != nullptr) d_ts[3 * r + a] = dts[a];
  }
  d_phase[r] = dphase;
}

__global__ void __launch_bounds__(kDiffThreads) sun_march_kernel(
    const float* __restrict__ dens, const float* __restrict__ to_sun, ds::diff::Grid3 g, float step,
    float dm, int n_steps, const float* __restrict__ pos, int64_t n, float* out, int* steps) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float ts[3], q[3];
  load3(to_sun, 0, ts);
  load3(pos, r, q);
  int n_in;
  out[r] = ds::diff::sun_march(dens, g, step, dm, n_steps, q, ts, &n_in);
  if (steps != nullptr) steps[r] = n_in;
}

__global__ void __launch_bounds__(kDiffThreads) sun_march_bwd_kernel(
    const float* __restrict__ dens, const float* __restrict__ to_sun, ds::diff::Grid3 g, float step,
    float dm, int n_steps, const float* __restrict__ pos, const float* __restrict__ trans,
    const float* __restrict__ g_trans, int64_t n, float* d_dens, float* d_pos, float* d_ts) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float ts[3], q[3], dq[3] = {0.0f, 0.0f, 0.0f}, dts[3] = {0.0f, 0.0f, 0.0f};
  load3(to_sun, 0, ts);
  load3(pos, r, q);
  ds::diff::sun_march_adjoint(dens, g, step, dm, n_steps, q, ts, trans[r], g_trans[r], d_dens, dq,
                        dts);
  for (int a = 0; a < 3; ++a) {
    d_pos[3 * r + a] = dq[a];
    d_ts[3 * r + a] = dts[a];
  }
}

static unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kDiffThreads - 1) / kDiffThreads);
}

extern "C" {

int ds_diff_threads() { return kDiffThreads; }

// K8a.  dens, trans, gbar: [nz * ny * nx] float32; d_dens: float64,
// zeroed by the caller and added to; consts as ds_bake's (bbox[3],
// light_dir[3], step, dm, max_dim); partials: [blocks][3], blocks =
// ceil(V / threads).
int ds_bake_adjoint(const float* dens, int nx, int ny, int nz, const float* consts,
                    int n_steps, const float* trans, const float* gbar, double* d_dens,
                    float* partials, void* stream) {
  const int64_t n = (int64_t)nx * ny * nz;
  if (n <= 0) return 0;
  const ds::diff::AdjConsts c = ds::diff::adj_consts(nx, ny, nz, consts);
  bake_adjoint_kernel<<<blocks_for(n), kDiffThreads, 0, (cudaStream_t)stream>>>(
      dens, c, n_steps, trans, gbar, d_dens, partials, n);
  return (int)cudaGetLastError();
}

// K8b forward.  baked: the in-scatter grid (NULL: the sun march from
// to_sun[3]); consts: bbox[3], step, dm, sun_ratio; entry, dirs: [n][3];
// phase: [n]; hit: [n] (a ray that misses writes 0); rad: [n]; steps: NULL
// or [n][2] (steps in the box, steps with sigma != 0).
int ds_diff_march(const float* dens, const float* baked, const float* to_sun, int nx, int ny,
                  int nz, const float* consts, int n_steps, int sun_steps, const float* entry,
                  const float* dirs, const float* phase, const uint8_t* hit, int64_t n,
                  float* rad, int* steps, void* stream) {
  if (n <= 0) return 0;
  const ds::diff::MarchConsts c =
      ds::diff::march_consts(nx, ny, nz, consts, n_steps, sun_steps, baked != nullptr);
  march_kernel<<<blocks_for(n), kDiffThreads, 0, (cudaStream_t)stream>>>(
      dens, baked, to_sun, c, entry, dirs, phase, hit, n, rad, steps);
  return (int)cudaGetLastError();
}

// K8b backward: d_dens (and d_baked) zeroed by the caller and added to;
// d_entry, d_dirs (and d_ts, pointwise): [n][3]; d_phase: [n].
int ds_diff_march_bwd(const float* dens, const float* baked, const float* to_sun, int nx,
                      int ny, int nz, const float* consts, int n_steps, int sun_steps,
                      const float* entry, const float* dirs, const float* phase,
                      const uint8_t* hit, const float* rad, const float* g_rad, int64_t n,
                      float* d_dens, float* d_baked, float* d_entry, float* d_dirs,
                      float* d_phase, float* d_ts, void* stream) {
  if (n <= 0) return 0;
  const ds::diff::MarchConsts c =
      ds::diff::march_consts(nx, ny, nz, consts, n_steps, sun_steps, baked != nullptr);
  march_bwd_kernel<<<blocks_for(n), kDiffThreads, 0, (cudaStream_t)stream>>>(
      dens, baked, to_sun, c, entry, dirs, phase, hit, rad, g_rad, n, d_dens, d_baked, d_entry,
      d_dirs, d_phase, d_ts);
  return (int)cudaGetLastError();
}

// The sun march from pos[n][3] toward to_sun[3]; consts: bbox[3], step, dm;
// steps: NULL or [n] (each point's samples in the box).
int ds_sun_march(const float* dens, const float* to_sun, int nx, int ny, int nz,
                 const float* consts, int n_steps, const float* pos, int64_t n, float* out,
                 int* steps, void* stream) {
  if (n <= 0) return 0;
  const ds::diff::Grid3 g = ds::diff::grid3(nx, ny, nz, consts);
  sun_march_kernel<<<blocks_for(n), kDiffThreads, 0, (cudaStream_t)stream>>>(
      dens, to_sun, g, consts[3], consts[4], n_steps, pos, n, out, steps);
  return (int)cudaGetLastError();
}

int ds_sun_march_bwd(const float* dens, const float* to_sun, int nx, int ny, int nz,
                     const float* consts, int n_steps, const float* pos, const float* trans,
                     const float* g_trans, int64_t n, float* d_dens, float* d_pos, float* d_ts,
                     void* stream) {
  if (n <= 0) return 0;
  const ds::diff::Grid3 g = ds::diff::grid3(nx, ny, nz, consts);
  sun_march_bwd_kernel<<<blocks_for(n), kDiffThreads, 0, (cudaStream_t)stream>>>(
      dens, to_sun, g, consts[3], consts[4], n_steps, pos, trans, g_trans, n, d_dens, d_pos,
      d_ts);
  return (int)cudaGetLastError();
}

}  // extern "C"

#endif  // DS_HOST_EMULATION
