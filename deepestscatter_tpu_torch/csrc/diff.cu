// K8a and K8b: the kernels of the differentiable single-scatter renderer
// (render/diff.py), each the adjoint, or the forward and the adjoint, of a
// loop that the JAX package leaves to XLA's reverse mode:
//
//   K8a  ds_bake_adjoint: the adjoint of deepestscatter_tpu/render/diff.py::
//        bake_inscatter_diff (lines 270-309).  Its forward is K3
//        (csrc/inscatter.cu::ds_bake with early_out = 0: the same positions
//        base + to_light * (step * i), the same taps, T *= exp(-sigma step)).
//   K8b  ds_diff_march / ds_diff_march_bwd: the quadrature march of
//        render_single_scatter (diff.py:198-238) and its adjoint, G lanes a
//        ray; ds_sun_march / ds_sun_march_bwd: the per-point sun march
//        sun_transmittance (diff.py:64-88) and its adjoint, G lanes or one
//        thread a point.  The same sun march is the quadrature's pointwise
//        in-scatter.
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
// The design.  Every kernel here was redesigned for the card; the first
// forms, a thread a voxel, ray or point, stay as bake_adjoint_voxel,
// march_ray, march_ray_adjoint, sun_march and sun_march_adjoint: the
// per-item statements of what they compute, and the designs
// csrc/diff_variants.cu times them against (chip_smoke.py,
// probes/march_variants.py; PERF.md).
//
//   K8a, a block an x-row segment (K3's row form, csrc/inscatter.cu), a
//   warp 32 V contiguous voxels of it, V = kAdjVoxels a thread.  At step i
//   every voxel of row (y, z) samples the same y and z: the row's y/z
//   cells, weights, slopes and the four density rows (z0|z1) x (y0|y1) the
//   taps read are computed once a row-step (adj_row_step).  A voxel sums
//   its weights along a run of steps in one cell in registers
//   (bake_adjoint_voxel's runs: the same float32 values, float64 sums) and
//   adds drho times them by float64 atomics when the run ends; its slope,
//   for the light gradient, regroups taps_slope's sum (the rows' x
//   differences, the rows interpolated along x and differenced in y and
//   z: a third of the operations).  A warp whose voxels have no gradient
//   leaves at once; the taps come from the grid through L1.
//   Measured against the first design, in the same run
//   (probes/march_variants.py, chip_smoke.py): about a sixth faster at
//   256^3.  Summing the runs in a float64 accumulator of the four rows in
//   shared memory, flushed when (y0, z0) changes, was slower than the
//   first design (60.4 ms against 43.1 at 256^3; PERF.md) and is not
//   kept: shared float64 atomics are compare-and-swap loops, and plain
//   read-modify-writes after a warp's merge of lanes on one texel are
//   latency chains, where the global atomics are fire and forget.
//   K8b's adjoint, G lanes a ray (K1's form, csrc/march.cu; G = 32 where
//   every ray's 32 lanes fit the card's thread slots at once, else 8,
//   ds_diff_lanes; so a ray's float32 sums take another order past that
//   count of rays):
//   lane l takes step c * G + l of chunk c.  The chunk's in-box span comes
//   from a ballot, tau, the prefix C and dP from the lanes' values in step
//   order (lane_sum: the additions of the per-ray loop, in its order), so
//   every per-step value equals march_ray_adjoint's.  A cell spans about two
//   steps at 256^3 (four at the defaults point), so consecutive lanes often
//   scatter into the same eight texels: a segmented scan over the group
//   sums them (group_deposit) and the last lane of each run of equal cells
//   does the eight atomics.  The first design, a thread a ray, lost about half its time
//   to its atomics' texel contention.
//   K8b's forward, the adjoint's lane form (ds_diff_forward_lanes: 32, 16
//   or 8 lanes a ray by the ray count): every lane samples the density at
//   its step, the span from a ballot, tau before each lane and after the
//   chunk and the radiance folded in step order (lane_sum, the lanes
//   outside the span adding an exact +0), so the radiance equals
//   march_ray's bitwise; only a lit lane takes its segment weight and NEE
//   point and reads the in-scatter, as march_ray does (in pointwise mode
//   its own sun march).  The first design ran a thread a ray, 16 blocks at
//   2,048 rays, each ray's chain of samples serial behind its early exit.
//   The sun march, a thread a point: strided samples, and in its adjoint
//   each run of steps in one cell summed in registers before its eight
//   atomics.  At the main path's voxel centres neighbouring threads march
//   neighbouring points, so their loads and atomics coalesce across the
//   warp; G lanes a point (sun_march_lanes, csrc/diff_variants.cu) lost
//   there, its ballots and folds costing more than they save.
#include "lanes.cuh"
#include "taps.cuh"

namespace ds {
namespace diff {

// Threads a block of the march and sun-march kernels, and the most a block
// of K8a's row kernel.
constexpr int kDiffThreads = 128;
// K8a: voxels a thread of its row kernel.  K8b's adjoint: lanes a ray,
// kDiffLanesFew where rays x kDiffLanesFew threads fit the card's thread
// slots, else kDiffLanes.  Measured (probes/march_variants.py, H100 at
// 700 W): 32 lanes 0.057 ms against 8 lanes' 0.104 on the defaults point's
// 2,048 rays; on the 256^3 frame's march at 16,384 to 131,072 rays 8 lanes
// are 9-28 % faster than 32 (16 lanes within 4 % of 8).
constexpr int kAdjVoxels = 2;
constexpr int kDiffLanes = 8;
constexpr int kDiffLanesFew = 32;

// ---------------------------------------------------------------------------
// The sun march: T = exp(-tau), tau += sigma(q + to_sun * step (j + 1)) step.
// A straight line leaves the box once (each coordinate is monotone in j,
// rounding included), and after it every sigma is 0 and tau unchanged: the
// march stops there.  *n_in: the samples taken in the box.
// ---------------------------------------------------------------------------

// Sun step j from q: its distance *s and unit coordinates u; false where
// the sample lies outside the box.
__device__ __forceinline__ bool sun_point(const Grid3& g, float step, const float* q,
                                          const float* ts, int j, float* s, float* u) {
  *s = step * (float)(j + 1);
  const float p[3] = {q[0] + ts[0] * *s, q[1] + ts[1] * *s, q[2] + ts[2] * *s};
  unit_coords(g, p, u);
  return inside_unit(u);
}

// Strided: each sample through trilinear_strided (the same taps, weights
// and sum order as taps_value(taps_at), so the same value, in 32-bit
// index math without the Taps kept); else taps_value (the first designs').
template <bool Strided = false>
__device__ __forceinline__ float sun_march(const float* __restrict__ dens, const Grid3& g,
                                           float step, float dm, int n, const float* q,
                                           const float* ts, int* n_in) {
  float tau = 0.0f;
  bool was_in = false;
  *n_in = 0;
  for (int j = 0; j < n; ++j) {
    float s, u[3];
    if (!sun_point(g, step, q, ts, j, &s, u)) {
      if (was_in) break;
      continue;
    }
    was_in = true;
    ++*n_in;
    const float sigma = (Strided ? trilinear_strided(dens, g.nx, g.ny, g.nz, u[0], u[1], u[2])
                                 : taps_value(dens, taps_at(g, u[0], u[1], u[2]))) *
                        dm;
    tau = tau + sigma * step;
  }
  return expf(-tau);
}

// The sun march's adjoint for upstream gT at T: density texels by atomics,
// d/dq into dq and d/d to_sun into dts (both added to).  With Merge, a run
// of steps in one cell sums its weights in registers and adds drho times
// the sums once the cell changes (and at the end), as K8a's runs do: eight
// atomics a run, not a step (the same terms to float32 rounding).
template <bool Merge, class Add>
__device__ __forceinline__ void sun_march_adjoint(const float* __restrict__ dens,
                                                  const Grid3& g, float step, float dm, int n,
                                                  const float* q, const float* ts, float T,
                                                  float gT, float* d_dens, float* dq,
                                                  float* dts, const Add& add) {
  // dtau = -gT T; dsigma_j = dtau step; d sample_j = dsigma_j dm.
  const float drho = ((-(gT * T)) * step) * dm;
  if (drho == 0.0f) return;
  bool was_in = false;
  int key = -1, run_idx[8];
  float run_w[8];
  for (int j = 0; j < n; ++j) {
    float s, u[3];
    if (!sun_point(g, step, q, ts, j, &s, u)) {
      if (was_in) break;
      continue;
    }
    was_in = true;
    const Taps t = taps_at(g, u[0], u[1], u[2]);
    float dp[3];
    if (Merge) {
      if (t.idx[0] != key) {
        if (key >= 0) {
#pragma unroll
          for (int k = 0; k < 8; ++k) add(d_dens + run_idx[k], drho * run_w[k]);
        }
        key = t.idx[0];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          run_idx[k] = t.idx[k];
          run_w[k] = t.w[k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) run_w[k] += t.w[k];
      }
      taps_point_slope(dens, g, t, drho, dp);
    } else {
      taps_adjoint(dens, g, t, drho, d_dens, dp, add);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      dq[a] += dp[a];
      dts[a] += dp[a] * s;
    }
  }
  if (Merge && key >= 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) add(d_dens + run_idx[k], drho * run_w[k]);
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

// Step i's density: st.s, st.tp and st.sigma; false where the sample lies
// outside the box (sigma = 0 there, an exact 0 term).
__device__ __forceinline__ bool step_density(const float* __restrict__ dens,
                                             const MarchConsts& c, const float* e,
                                             const float* d, int i, Step& st) {
  st.s = c.step * (float)(i + 1);
  const float p[3] = {e[0] + d[0] * st.s, e[1] + d[1] * st.s, e[2] + d[2] * st.s};
  float u[3];
  unit_coords(c.g, p, u);
  if (!inside_unit(u)) return false;
  st.tp = taps_at(c.g, u[0], u[1], u[2]);
  st.sigma = taps_value(dens, st.tp) * c.dm;
  return true;
}

// step_density's st.s and st.sigma alone (no taps kept): the same taps,
// weights and sum order through trilinear_strided, so the same sigma.
__device__ __forceinline__ bool step_sigma(const float* __restrict__ dens, const MarchConsts& c,
                                           const float* e, const float* d, int i, Step& st) {
  st.s = c.step * (float)(i + 1);
  const float p[3] = {e[0] + d[0] * st.s, e[1] + d[1] * st.s, e[2] + d[2] * st.s};
  float u[3];
  unit_coords(c.g, p, u);
  if (!inside_unit(u)) return false;
  st.sigma = trilinear_strided(dens, c.g.nx, c.g.ny, c.g.nz, u[0], u[1], u[2]) * c.dm;
  return true;
}

// The rest of step_sample past step_density: the segment weight and the
// NEE point.
__device__ __forceinline__ void step_segment(const MarchConsts& c, const float* e,
                                             const float* d, Step& st) {
  const float p[3] = {e[0] + d[0] * st.s, e[1] + d[1] * st.s, e[2] + d[2] * st.s};
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
}

// Step i of the ray (entry e, direction d) but its view transmittance
// st.tv (the one value that carries from step to step); false where the
// sample lies outside the box.
__device__ __forceinline__ bool step_sample(const float* __restrict__ dens, const MarchConsts& c,
                                            const float* e, const float* d, int i, Step& st) {
  if (!step_density(dens, c, e, d, i, st)) return false;
  step_segment(c, e, d, st);
  return true;
}

// step_sample at optical depth tau.
__device__ __forceinline__ bool step_at(const float* __restrict__ dens, const MarchConsts& c,
                                        const float* e, const float* d, int i, float tau,
                                        Step& st) {
  if (!step_sample(dens, c, e, d, i, st)) return false;
  st.tv = expf(-tau);
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
// the sun march (its samples in the box into *n_sun; 0 baked; Strided:
// sun_march's).
template <bool Strided = false>
__device__ __forceinline__ float t_sun_at(const float* __restrict__ dens,
                                          const float* __restrict__ baked,
                                          const MarchConsts& c, const float* ts, const float* q,
                                          Taps* tq, int* n_sun) {
  if (c.baked) {
    float u[3];
    unit_coords(c.g, q, u);
    *tq = taps_at(c.g, u[0], u[1], u[2]);
    *n_sun = 0;
    return taps_value(baked, *tq);
  }
  return sun_march<Strided>(dens, c.g, c.step, c.dm, c.sun_steps, q, ts, n_sun);
}

// A ray's radiance sum; counts[0] its steps in the box, counts[1] those
// with sigma != 0 (where the in-scatter is read), counts[2] the sun
// march's samples in the box at those steps (0 baked).
__device__ __forceinline__ float march_ray(const float* __restrict__ dens,
                                           const float* __restrict__ baked,
                                           const MarchConsts& c, const float* ts,
                                           const float* e, const float* d, float phase,
                                           int* counts) {
  float tau = 0.0f, rad = 0.0f;
  bool was_in = false;
  int n_in = 0, n_lit = 0, n_sun = 0;
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
      int ns;
      const float S = t_sun_at(dens, baked, c, ts, st.q, &tq, &ns);
      n_sun += ns;
      rad = rad + (((st.tv * st.seg) * S) * phase) * c.sun_ratio;
    }
    tau = tau + st.sigma * c.step;
  }
  counts[0] = n_in;
  counts[1] = n_lit;
  counts[2] = n_sun;
  return rad;
}

// Step st's adjoint, for upstream g at the forward's radiance R, given its
// in-scatter S (baked: taps tq) and the prefix C through it: the density
// texels' values (at st.tp.idx) into vd[8], the baked grid's (at tq.idx;
// zeros where nothing is scattered) into vb[8]; the pointwise sun march's
// density adjoint through add; d/d entry, d/d dirs, d/d to_sun added to
// de, dd, dts.
template <class Add>
__device__ __forceinline__ void step_adjoint(const float* __restrict__ dens,
                                             const float* __restrict__ baked,
                                             const MarchConsts& c, const float* ts,
                                             const float* d, float phase, float R, float g,
                                             const Step& st, float S, const Taps& tq, float C,
                                             float* d_dens, float* vd, float* vb, float* de,
                                             float* dd, float* dts, const Add& add) {
  const float tvseg = st.tv * st.seg;
  // Through the later steps' view transmittance, and the segment weight.
  float dsigma = g * ((-c.step) * (R - C)) +
                 g * ((((st.tv * (st.e1 * c.step)) * S) * phase) * c.sun_ratio);
  const float dS = ((tvseg * phase) * c.sun_ratio) * g;
  float dp[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 8; ++k) vb[k] = 0.0f;
  if (dS != 0.0f) {
    float dq[3] = {0.0f, 0.0f, 0.0f};
    if (c.baked) {
#pragma unroll
      for (int k = 0; k < 8; ++k) vb[k] = dS * tq.w[k];
      taps_point_slope(baked, c.g, tq, dS, dq);
    } else {
      sun_march_adjoint<false>(dens, c.g, c.step, c.dm, c.sun_steps, st.q, ts, S, dS, d_dens, dq,
                               dts, add);
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
  const float s = dsigma * c.dm;
#pragma unroll
  for (int k = 0; k < 8; ++k) vd[k] = s * st.tp.w[k];
  float dps[3];
  taps_point_slope(dens, c.g, st.tp, s, dps);
  // p = e + d s.
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t = dp[a] + dps[a];
    de[a] += t;
    dd[a] += t * st.s;
  }
}

// The ray's adjoint for upstream g at the forward's radiance R, a step at a
// time (the first design: a thread a ray): density (and baked-grid) texels
// through add; d/d entry, d/d dirs, d/d to_sun (pointwise) added to de,
// dd, dts; returns d/d phase.
template <class Add>
__device__ __forceinline__ float march_ray_adjoint(
    const float* __restrict__ dens, const float* __restrict__ baked, const MarchConsts& c,
    const float* ts, const float* e, const float* d, float phase, float R, float g,
    float* d_dens, float* d_baked, float* de, float* dd, float* dts, const Add& add) {
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
    int ns;
    const float S = t_sun_at(dens, baked, c, ts, st.q, &tq, &ns);
    const float tvseg = st.tv * st.seg;
    C = C + ((tvseg * S) * phase) * c.sun_ratio;  // the prefix through this step
    dP = dP + (tvseg * S) * c.sun_ratio;
    float vd[8], vb[8];
    step_adjoint(dens, baked, c, ts, d, phase, R, g, st, S, tq, C, d_dens, vd, vb, de, dd, dts,
                 add);
    if (c.baked) {
#pragma unroll
      for (int k = 0; k < 8; ++k) add(d_baked + tq.idx[k], vb[k]);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) add(d_dens + st.tp.idx[k], vd[k]);
    tau = tau + st.sigma * c.step;
  }
  return dP * g;
}

// -- the lane form: G lanes a ray, lane l on step c * G + l of chunk c -------

// One lane's step of a chunk: whether it lies in the box, its values (st.tv
// once the chunk's tau is known) and its in-scatter.
struct LaneDiff {
  bool in;
  Step st;
  float S;
  Taps tq;
};

__device__ __forceinline__ void lane_sample(const float* __restrict__ dens,
                                            const float* __restrict__ baked,
                                            const MarchConsts& c, const float* ts,
                                            const float* e, const float* d, int i,
                                            LaneDiff& L) {
  L.in = i < c.n_steps && step_sample(dens, c, e, d, i, L.st);
  L.S = 0.0f;
  int ns;
  if (L.in) L.S = t_sun_at<true>(dens, baked, c, ts, L.st.q, &L.tq, &ns);
}

// The steps of a chunk the ray takes: lanes [start, end); ended where the
// ray left the box in it.  Bit k of `in` is set where lane k's sample lies
// in the box; before the ray's first such step (was_in false) the lanes
// out of the box are skipped, after it the first lane out of the box ends
// the ray (march_ray_adjoint's continue and break).
struct LaneSpan {
  int start, end;
  bool ended;
};

__device__ __forceinline__ LaneSpan lane_span(unsigned in, bool was_in, int G) {
  LaneSpan s;
  s.start = 0;
  if (!was_in) {
    if (in == 0u) {
      s.start = s.end = G;
      s.ended = false;
      return s;
    }
    s.start = lowest_lane(in);
  }
  const unsigned out = ~in & group_bits(G) & ~group_bits(s.start);
  s.end = out != 0u ? lowest_lane(out) : G;
  s.ended = out != 0u;
  return s;
}

// x0 + x_of(0) + ... + x_of(G - 1), in that order, and into *before lane
// `at`'s prefix x0 + ... + x_of(at - 1), in one pass; x_of(k) gives lane
// k's value (a shuffle on the card: every lane calls it for every k).  The
// lanes outside a chunk's span (and, in a sum over lit steps, the dark
// ones) give +0, so this is the sum over the span's values alone, in step
// order, bitwise: x + 0 == x for every float but -0, and a running sum
// from +0 is never -0 (-0 results only from two -0 under round-to-nearest).
template <int G, class X>
__device__ __forceinline__ float lane_sum(float x0, int at, X x_of, float* before) {
  float t = x0;
  *before = x0;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const float xk = x_of(k);
    if (k == at) *before = t;
    t = t + xk;
  }
  return t;
}

template <int G, class X>
__device__ __forceinline__ float lane_sum(float x0, X x_of) {
  float before;
  return lane_sum<G>(x0, -1, x_of, &before);
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
template <class Add = AddTo>
__device__ __forceinline__ void bake_adjoint_voxel(int64_t v, const float* __restrict__ dens,
                                                   const AdjConsts& c, int n_steps, float T,
                                                   float gbar, double* d_dens, float* dl,
                                                   const Add& add = Add()) {
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
      for (int j = 0; j < n_run; ++j) add(d_dens + run_idx[j], drho * run_w[j]);
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
  for (int j = 0; j < n_run; ++j) add(d_dens + run_idx[j], drho * run_w[j]);
}

// -- the row form: the voxels of an x-row at one step ------------------------

// What the voxels of row (y, z) share at step i: the distance s; the y and
// z weights and slope scales (taps_at's); wzy[q] = wz[iz] * wy[iy] of the
// four texture rows q = iz * 2 + iy the taps read, and the same products
// with a clamped axis's two taps merged (bake_adjoint_voxel's, 0 where
// merged away: the run weights'); the rows' offsets; the window key
// z0 * ny + y0 (a change ends every run).
struct AdjRow {
  float s;
  float wy[2], wz[2];
  float sy, sz;
  float wzy[4];
  float mzy[4];
  int off[4];
  int key;
};

__device__ __forceinline__ AdjRow adj_row_step(const AdjConsts& c, float by, float bz, int i) {
  AdjRow r;
  r.s = c.step * (float)i;
  const float py = by + (-c.light[1]) * r.s, pz = bz + (-c.light[2]) * r.s;
  const float ty = div_exact(py, c.g.bbox[1], c.g.inv_bbox[1]) * (float)c.g.ny - 0.5f;
  const float tz = div_exact(pz, c.g.bbox[2], c.g.inv_bbox[2]) * (float)c.g.nz - 0.5f;
  const AxisCell cy = axis_cell(ty, c.g.ny);
  const AxisCell cz = axis_cell(tz, c.g.nz);
  r.wy[0] = 1.0f - cy.frac;
  r.wy[1] = cy.frac;
  r.wz[0] = 1.0f - cz.frac;
  r.wz[1] = cz.frac;
  r.sy = floorf(ty) < 0.0f ? 0.0f : (float)c.g.ny;
  r.sz = floorf(tz) < 0.0f ? 0.0f : (float)c.g.nz;
  const bool my = cy.i0 == cy.i1, mz = cz.i0 == cz.i1;
  const float wym[2] = {my ? r.wy[0] + r.wy[1] : r.wy[0], my ? 0.0f : r.wy[1]};
  const float wzm[2] = {mz ? r.wz[0] + r.wz[1] : r.wz[0], mz ? 0.0f : r.wz[1]};
  const int ys[2] = {cy.i0, cy.i1};
  const int zs[2] = {cz.i0, cz.i1};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int iy = q & 1, iz = q >> 1;
    r.wzy[q] = r.wz[iz] * r.wy[iy];
    r.mzy[q] = wzm[iz] * wym[iy];
    r.off[q] = (zs[iz] * c.g.ny + ys[iy]) * c.g.nx;
  }
  r.key = cz.i0 * c.g.ny + cy.i0;
  return r;
}

// One voxel of a row: its base x, drho (0: no gradient, no run), its
// light-gradient sum, its last step's texel column x0 (-1 before the
// window's first step) and its run: the summed weights of slot
// k = ix + 2 * q since its step in column x0.
struct AdjVoxel {
  float bx, drho;
  float dl[3];
  int x0;
  float w[8];
};

__device__ __forceinline__ void adj_voxel_init(AdjVoxel& v, const AdjConsts& c, int x, float T,
                                               float gbar) {
  v.bx = (float)x / c.max_dim;
  // dT / dsigma_k = -step T at every step; d sample_k = dsigma_k dm.
  v.drho = ((-(gbar * T)) * c.step) * c.dm;
  v.dl[0] = v.dl[1] = v.dl[2] = 0.0f;
  v.x0 = -1;
}

// A voxel's x cell at row step r (taps_at's x axis).
struct XCell {
  int i0, i1;
  float wx[2];
  float sx;
};

__device__ __forceinline__ XCell adj_x_cell(const AdjConsts& c, const AdjRow& r, float bx) {
  const float px = bx + (-c.light[0]) * r.s;
  const float tx = div_exact(px, c.g.bbox[0], c.g.inv_bbox[0]) * (float)c.g.nx - 0.5f;
  const AxisCell cx = axis_cell(tx, c.g.nx);
  XCell x;
  x.i0 = cx.i0;
  x.i1 = cx.i1;
  x.wx[0] = 1.0f - cx.frac;
  x.wx[1] = cx.frac;
  x.sx = floorf(tx) < 0.0f ? 0.0f : (float)c.g.nx;
  return x;
}

// Whether v's run ends at a step in column x0.
__device__ __forceinline__ bool adj_run_ends(const AdjVoxel& v, int x0) {
  return v.x0 >= 0 && x0 != v.x0;
}

// v's run, where it has one and it ends, straight into the density
// gradient at the window's rows off[4]: the values drho * w that
// bake_adjoint_voxel adds, by float64 atomics (add_to; zeros skipped).
__device__ __forceinline__ void adj_run_add(const AdjVoxel& v, bool ends, const int* off, int nx,
                                            double* d_dens) {
  if (!ends || v.drho == 0.0f) return;
  const int x1 = v.x0 + 1 > nx - 1 ? nx - 1 : v.x0 + 1;
#pragma unroll
  for (int k = 0; k < 8; ++k) add_to(d_dens + off[k >> 1] + ((k & 1) ? x1 : v.x0), v.drho * v.w[k]);
}

// Voxel v's step in cell xc at row step r, from the window's density rows
// (dens + off[q], the taps read through L1): its slope into the light gradient, and its run's
// weights (a new run where the column changed).  The caller has added an
// ended run; v.x0 becomes the step's column.  The slope is taps_slope's
// sum regrouped (the rows' x differences, and the rows interpolated along
// x, differenced in y and z): a third of its operations, the same value
// to float32 rounding.
__device__ __forceinline__ void adj_voxel_step(const float* __restrict__ dens, const int* off,
                                               const AdjConsts& c, const AdjRow& r,
                                               const XCell& xc, AdjVoxel& v) {
  float gx = 0.0f, e[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float v0 = dens[off[q] + xc.i0], v1 = dens[off[q] + xc.i1];
    gx = q == 0 ? r.wzy[0] * (v1 - v0) : gx + r.wzy[q] * (v1 - v0);
    e[q] = v0 * xc.wx[0] + v1 * xc.wx[1];
  }
  const float gy = r.wz[0] * (e[1] - e[0]) + r.wz[1] * (e[3] - e[2]);
  const float gz = r.wy[0] * (e[2] - e[0]) + r.wy[1] * (e[3] - e[1]);
  const float du[3] = {gx * xc.sx, gy * r.sy, gz * r.sz};
  // p = base + (-light) s.
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    v.dl[a] -= div_exact(v.drho * du[a], c.g.bbox[a], c.g.inv_bbox[a]) * r.s;
  }
  const bool mx = xc.i0 == xc.i1;
  const float wxm[2] = {mx ? xc.wx[0] + xc.wx[1] : xc.wx[0], mx ? 0.0f : xc.wx[1]};
  if (xc.i0 != v.x0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) v.w[k] = r.mzy[k >> 1] * wxm[k & 1];
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v.w[k] += r.mzy[k >> 1] * wxm[k & 1];
  }
  v.x0 = xc.i0;
}

// Row (y, z)'s adjoint, one voxel after the other at each step: the
// formulation the row kernel runs with a block of threads (each ended run
// added straight into the gradient, as the kernel's lanes add theirs).
// vox: scratch of nx voxels; dl: the row's light gradient, each voxel's
// summed in float64 in x order.
__device__ __forceinline__ void bake_adjoint_row(int y, int z, const float* __restrict__ dens,
                                                 const AdjConsts& c, int n_steps,
                                                 const float* trans_row, const float* g_row,
                                                 AdjVoxel* vox, double* d_dens, double* dl) {
  const int nx = c.g.nx;
  const float by = (float)y / c.max_dim, bz = (float)z / c.max_dim;
  bool any = false;
  for (int x = 0; x < nx; ++x) {
    adj_voxel_init(vox[x], c, x, trans_row[x], g_row[x]);
    any = any || vox[x].drho != 0.0f;
  }
  dl[0] = dl[1] = dl[2] = 0.0;
  if (!any) return;
  int key = -1, off[4] = {0, 0, 0, 0};
  for (int i = 0; i < n_steps; ++i) {
    const AdjRow r = adj_row_step(c, by, bz, i);
    if (r.key != key) {
      for (int x = 0; x < nx; ++x) {
        adj_run_add(vox[x], vox[x].x0 >= 0, off, nx, d_dens);
        vox[x].x0 = -1;
      }
      key = r.key;
      for (int q = 0; q < 4; ++q) off[q] = r.off[q];
    }
    for (int x = 0; x < nx; ++x) {
      AdjVoxel& v = vox[x];
      if (v.drho == 0.0f) continue;
      const XCell xc = adj_x_cell(c, r, v.bx);
      adj_run_add(v, adj_run_ends(v, xc.i0), off, nx, d_dens);
      adj_voxel_step(dens, off, c, r, xc, v);
    }
  }
  for (int x = 0; x < nx; ++x) adj_run_add(vox[x], vox[x].x0 >= 0, off, nx, d_dens);
  for (int x = 0; x < nx; ++x) {
    for (int a = 0; a < 3; ++a) dl[a] += (double)vox[x].dl[a];
  }
}

// The row kernel's launch: threads a block and segments a row for V voxels
// a thread (K3's launch_rows), and the partial rows of the light gradient
// (one a warp).
struct RowLaunch {
  int threads, segments;
  int64_t blocks;
  int64_t partials;  // one a warp
};

inline RowLaunch row_launch(int nx, int ny, int nz, int V) {
  RowLaunch L;
  const int per_thread = (nx + V - 1) / V;
  L.threads = (per_thread + 31) / 32 * 32;
  if (L.threads > kDiffThreads) L.threads = kDiffThreads;
  L.segments = (nx + L.threads * V - 1) / (L.threads * V);
  L.blocks = (int64_t)ny * nz * L.segments;
  L.partials = L.blocks * (L.threads / 32);
  return L;
}

}  // namespace diff
}  // namespace ds

#ifndef DS_HOST_EMULATION

using ds::diff::kDiffThreads;

// Sums each thread's v[3] over the block into out[3] (thread 0 writes), in
// a fixed order.
template <typename F>
__device__ __forceinline__ void block_sum3(F* v, F* out) {
  __shared__ F warp_sums[kDiffThreads / 32][3];
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
      F acc = 0;
      for (int w = 0; w < (int)(blockDim.x >> 5); ++w) acc += warp_sums[w][a];
      out[a] = acc;
    }
  }
}

// K8a: block (row = y + ny * z, segment) of blockDim.x * V voxels; warp w
// carries the 32 V voxels from segment * blockDim.x * V + w * 32 * V, lane
// t of them x = ... + j * 32 + t, j < V (bake_adjoint_row over a block of
// threads).  Warps are independent: one without a voxel with a gradient
// leaves at once.  Each lane adds its runs that end by float64 atomics,
// fire and forget (adj_run_add).  partials: each warp's light gradient, at
// (block index) * warps + warp.
template <int V>
__global__ void __launch_bounds__(kDiffThreads) bake_adjoint_rows_kernel(
    const float* __restrict__ dens, ds::diff::AdjConsts c, int n_steps,
    const float* __restrict__ trans, const float* __restrict__ gbar, double* __restrict__ d_dens,
    double* __restrict__ partials) {
  const int nx = c.g.nx, ny = c.g.ny;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x;
  const int y = row % ny, z = row / ny;
  const int x0 = (blockIdx.y * warps + warp) * 32 * V + lane;
  const float by = (float)y / c.max_dim, bz = (float)z / c.max_dim;
  double* part_out =
      partials + 3 * (((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * warps + warp);
  ds::diff::AdjVoxel vox[V];
  bool any = false;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int x = x0 + j * 32;
    float T = 0.0f, g = 0.0f;
    if (x < nx) {
      T = trans[(int64_t)row * nx + x];
      g = gbar[(int64_t)row * nx + x];
    }
    ds::diff::adj_voxel_init(vox[j], c, x, T, g);
    any = any || vox[j].drho != 0.0f;
  }
  if (!__any_sync(0xffffffffu, any)) {
    if (lane == 0) part_out[0] = part_out[1] = part_out[2] = 0.0;
    return;
  }
  int key = -1, off[4] = {0, 0, 0, 0};
  for (int i = 0; i < n_steps; ++i) {
    const ds::diff::AdjRow r = ds::diff::adj_row_step(c, by, bz, i);
    if (r.key != key) {  // the same for the whole warp: every run ends
#pragma unroll
      for (int j = 0; j < V; ++j) {
        ds::diff::adj_run_add(vox[j], vox[j].x0 >= 0, off, nx, d_dens);
        vox[j].x0 = -1;
      }
      key = r.key;
#pragma unroll
      for (int q = 0; q < 4; ++q) off[q] = r.off[q];
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      ds::diff::AdjVoxel& v = vox[j];
      if (v.drho == 0.0f) continue;
      const ds::diff::XCell xc = ds::diff::adj_x_cell(c, r, v.bx);
      ds::diff::adj_run_add(v, ds::diff::adj_run_ends(v, xc.i0), off, nx, d_dens);
      ds::diff::adj_voxel_step(dens, off, c, r, xc, v);
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    ds::diff::adj_run_add(vox[j], vox[j].x0 >= 0, off, nx, d_dens);
  }
  double part[3] = {0.0, 0.0, 0.0};
#pragma unroll
  for (int j = 0; j < V; ++j) {
#pragma unroll
    for (int a = 0; a < 3; ++a) part[a] += (double)vox[j].dl[a];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part[a] += __shfl_down_sync(0xffffffffu, part[a], o);
  }
  if (lane == 0) {
    for (int a = 0; a < 3; ++a) part_out[a] = part[a];
  }
}

// K8a with V voxels a thread (ds_bake_adjoint's arguments).
template <int V>
static int bake_adjoint_rows(const float* dens, int nx, int ny, int nz, const float* consts,
                             int n_steps, const float* trans, const float* gbar,
                             double* d_dens, double* partials, void* stream) {
  if ((int64_t)nx * ny * nz <= 0) return 0;
  const ds::diff::AdjConsts c = ds::diff::adj_consts(nx, ny, nz, consts);
  const ds::diff::RowLaunch L = ds::diff::row_launch(nx, ny, nz, V);
  const dim3 grid((unsigned)(ny * nz), (unsigned)L.segments);
  bake_adjoint_rows_kernel<V><<<grid, L.threads, 0, (cudaStream_t)stream>>>(
      dens, c, n_steps, trans, gbar, d_dens, partials);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ void load3(const float* p, int64_t r, float* out) {
  out[0] = p[3 * r];
  out[1] = p[3 * r + 1];
  out[2] = p[3 * r + 2];
}

// K8b's forward: rays x G threads, group g of G lanes taking ray
// blockIdx * (threads / G) + g a chunk of G steps at a time (march_ray in
// the adjoint's lane form).  Every lane samples the density at its step
// (step_sigma); the chunk's span comes from a ballot, tau before each lane
// and after the chunk from one pass over the lanes, the radiance from the
// lanes' terms in step order (lane_sum, a lane outside the span or dark
// giving +0): march_ray's additions in its order, so the radiance and the
// counts equal march_ray's bitwise.  Only a lit lane (sigma != 0) takes
// the rest of its step (the segment weight, the NEE point) and reads the
// in-scatter, as march_ray does: the baked grid's tap or, in pointwise
// mode, its own sun march.
template <int G>
__global__ void __launch_bounds__(kDiffThreads) march_lanes_kernel(
    const float* __restrict__ dens, const float* __restrict__ baked,
    const float* __restrict__ to_sun, ds::diff::MarchConsts c, const float* __restrict__ entry,
    const float* __restrict__ dirs, const float* __restrict__ phase,
    const uint8_t* __restrict__ hit, int64_t n, float* rad, int* steps) {
  const GroupLanes gr = group_lanes<G>();
  const int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (r >= n) return;  // whole groups: the block is a multiple of G
  int n_in = 0, n_lit = 0, n_sun = 0;
  float R = 0.0f;
  if (hit[r]) {  // uniform over the group
    float ts[3] = {0.0f, 0.0f, 0.0f}, e[3], d[3];
    if (!c.baked) load3(to_sun, 0, ts);
    load3(entry, r, e);
    load3(dirs, r, d);
    const float ph = phase[r];
    float tau = 0.0f;
    bool was_in = false;
    for (int i0 = 0; i0 < c.n_steps; i0 += G) {
      ds::diff::Step st;
      const bool in =
          i0 + gr.gl < c.n_steps && ds::diff::step_sigma(dens, c, e, d, i0 + gr.gl, st);
      const unsigned bits = __ballot_sync(gr.mask, in) >> gr.shift;
      const ds::diff::LaneSpan sp = ds::diff::lane_span(bits, was_in, G);
      const bool mine = gr.gl >= sp.start && gr.gl < sp.end;
      const float xs = mine ? st.sigma * c.step : 0.0f;
      float tau_l;
      tau = ds::diff::lane_sum<G>(
          tau, gr.gl, [&](int k) { return __shfl_sync(gr.mask, xs, k, G); }, &tau_l);
      // sigma == 0: seg == 0, the term is an exact 0.
      const bool lit = mine && st.sigma != 0.0f;
      const unsigned lit_bits = __ballot_sync(gr.mask, lit) >> gr.shift;
      if (lit) ds::diff::step_segment(c, e, d, st);
      float S = 0.0f;
      if (lit) {
        ds::diff::Taps tq;
        int ns;
        S = ds::diff::t_sun_at<true>(dens, baked, c, ts, st.q, &tq, &ns);
        n_sun += ns;
      }
      float term = 0.0f;
      if (lit) term = (((expf(-tau_l) * st.seg) * S) * ph) * c.sun_ratio;
      R = ds::diff::lane_sum<G>(R, [&](int k) { return __shfl_sync(gr.mask, term, k, G); });
      n_in += sp.end - sp.start;
      n_lit += __popc(lit_bits);
      was_in = was_in || sp.start < sp.end;
      if (sp.ended) break;
    }
  }
  // Each lit lane's sun samples, summed over the group.
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) n_sun += __shfl_down_sync(gr.mask, n_sun, o, G);
  if (gr.gl == 0) {
    rad[r] = R;
    if (steps != nullptr) {
      steps[3 * r] = n_in;
      steps[3 * r + 1] = n_lit;
      steps[3 * r + 2] = n_sun;
    }
  }
}

// K8b's forward with G lanes a ray (ds_diff_march's arguments).
template <int G>
static int march_lanes_launch(const float* dens, const float* baked, const float* to_sun,
                              int nx, int ny, int nz, const float* consts, int n_steps,
                              int sun_steps, const float* entry, const float* dirs,
                              const float* phase, const uint8_t* hit, int64_t n, float* rad,
                              int* steps, void* stream) {
  if (n <= 0) return 0;
  const ds::diff::MarchConsts c =
      ds::diff::march_consts(nx, ny, nz, consts, n_steps, sun_steps, baked != nullptr);
  const unsigned blocks = (unsigned)((n * G + kDiffThreads - 1) / kDiffThreads);
  march_lanes_kernel<G><<<blocks, kDiffThreads, 0, (cudaStream_t)stream>>>(
      dens, baked, to_sun, c, entry, dirs, phase, hit, n, rad, steps);
  return (int)cudaGetLastError();
}

// The sun march a thread a point, each sample through trilinear_strided.
__global__ void __launch_bounds__(kDiffThreads) sun_march_points_kernel(
    const float* __restrict__ dens, const float* __restrict__ to_sun, ds::diff::Grid3 g, float step,
    float dm, int n_steps, const float* __restrict__ pos, int64_t n, float* out, int* steps) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float ts[3], q[3];
  load3(to_sun, 0, ts);
  load3(pos, r, q);
  int n_in;
  out[r] = ds::diff::sun_march<true>(dens, g, step, dm, n_steps, q, ts, &n_in);
  if (steps != nullptr) steps[r] = n_in;
}

// Its adjoint a thread a point, each run of steps in one cell merged in
// registers before its eight atomics (sun_march_adjoint's Merge).
template <class Add = ds::diff::AddTo>
__global__ void __launch_bounds__(kDiffThreads) sun_march_bwd_points_kernel(
    const float* __restrict__ dens, const float* __restrict__ to_sun, ds::diff::Grid3 g, float step,
    float dm, int n_steps, const float* __restrict__ pos, const float* __restrict__ trans,
    const float* __restrict__ g_trans, int64_t n, float* d_dens, float* d_pos, float* d_ts) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float ts[3], q[3], dq[3] = {0.0f, 0.0f, 0.0f}, dts[3] = {0.0f, 0.0f, 0.0f};
  load3(to_sun, 0, ts);
  load3(pos, r, q);
  ds::diff::sun_march_adjoint<true>(dens, g, step, dm, n_steps, q, ts, trans[r], g_trans[r],
                                    d_dens, dq, dts, Add());
  for (int a = 0; a < 3; ++a) {
    d_pos[3 * r + a] = dq[a];
    d_ts[3 * r + a] = dts[a];
  }
}

// The sun march and its adjoint a thread a point (ds_sun_march's and
// ds_sun_march_bwd's arguments).
static int sun_march_launch(const float* dens, const float* to_sun, int nx, int ny, int nz,
                            const float* consts, int n_steps, const float* pos, int64_t n,
                            float* out, int* steps, void* stream) {
  if (n <= 0) return 0;
  const ds::diff::Grid3 g = ds::diff::grid3(nx, ny, nz, consts);
  const unsigned blocks = (unsigned)((n + kDiffThreads - 1) / kDiffThreads);
  sun_march_points_kernel<<<blocks, kDiffThreads, 0, (cudaStream_t)stream>>>(
      dens, to_sun, g, consts[3], consts[4], n_steps, pos, n, out, steps);
  return (int)cudaGetLastError();
}

template <class Add = ds::diff::AddTo>
static int sun_march_bwd_launch(const float* dens, const float* to_sun, int nx, int ny, int nz,
                                const float* consts, int n_steps, const float* pos,
                                const float* trans, const float* g_trans, int64_t n,
                                float* d_dens, float* d_pos, float* d_ts, void* stream) {
  if (n <= 0) return 0;
  const ds::diff::Grid3 g = ds::diff::grid3(nx, ny, nz, consts);
  const unsigned blocks = (unsigned)((n + kDiffThreads - 1) / kDiffThreads);
  sun_march_bwd_points_kernel<Add><<<blocks, kDiffThreads, 0, (cudaStream_t)stream>>>(
      dens, to_sun, g, consts[3], consts[4], n_steps, pos, trans, g_trans, n, d_dens, d_pos,
      d_ts);
  return (int)cudaGetLastError();
}

// K8b's adjoint: rays x G threads, group g of G lanes taking ray
// blockIdx * (threads / G) + g a chunk of G steps at a time.
template <int G, class Add>
__device__ __forceinline__ void march_bwd_lanes(
    const float* __restrict__ dens, const float* __restrict__ baked,
    const float* __restrict__ to_sun, const ds::diff::MarchConsts& c,
    const float* __restrict__ entry, const float* __restrict__ dirs,
    const float* __restrict__ phase, const uint8_t* __restrict__ hit,
    const float* __restrict__ rad, const float* __restrict__ g_rad, int64_t n, float* d_dens,
    float* d_baked, float* d_entry, float* d_dirs, float* d_phase, float* d_ts,
    const Add& add) {
  const GroupLanes gr = group_lanes<G>();
  const int gl = gr.gl, shift = gr.shift;
  const unsigned gmask = gr.mask;
  const int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (r >= n) return;  // whole groups: the block is a multiple of G
  float de[3] = {0.0f, 0.0f, 0.0f}, dd[3] = {0.0f, 0.0f, 0.0f}, dts[3] = {0.0f, 0.0f, 0.0f};
  float dP = 0.0f;
  const float g = g_rad[r];
  if (hit[r] && g != 0.0f) {  // uniform over the group
    float ts[3] = {0.0f, 0.0f, 0.0f}, e[3], d[3];
    if (!c.baked) load3(to_sun, 0, ts);
    load3(entry, r, e);
    load3(dirs, r, d);
    const float ph = phase[r], R = rad[r];
    float tau = 0.0f, C = 0.0f;
    bool was_in = false;
    for (int i0 = 0; i0 < c.n_steps; i0 += G) {
      ds::diff::LaneDiff L;
      ds::diff::lane_sample(dens, baked, c, ts, e, d, i0 + gl, L);
      const unsigned in = __ballot_sync(gmask, L.in) >> shift;
      const ds::diff::LaneSpan sp = ds::diff::lane_span(in, was_in, G);
      const bool mine = gl >= sp.start && gl < sp.end;
      // tau before this lane's step and after the chunk, in step order.
      const float xs = mine ? L.st.sigma * c.step : 0.0f;
      float tau_l;
      tau = ds::diff::lane_sum<G>(
          tau, gl, [&](int k) { return __shfl_sync(gmask, xs, k, G); }, &tau_l);
      float term = 0.0f, dterm = 0.0f;
      if (mine) {
        L.st.tv = expf(-tau_l);
        const float tvseg = L.st.tv * L.st.seg;
        term = ((tvseg * L.S) * ph) * c.sun_ratio;
        dterm = (tvseg * L.S) * c.sun_ratio;
      }
      // The prefix through this lane's step (the next addition after the
      // prefix before it); dP through the chunk.
      float C_before;
      C = ds::diff::lane_sum<G>(
          C, gl, [&](int k) { return __shfl_sync(gmask, term, k, G); }, &C_before);
      const float C_l = C_before + term;
      dP = ds::diff::lane_sum<G>(dP, [&](int k) { return __shfl_sync(gmask, dterm, k, G); });
      float vd[8], vb[8];
      int key_d = -1 - gl, key_b = -1 - gl;
      if (mine) {
        ds::diff::step_adjoint(dens, baked, c, ts, d, ph, R, g, L.st, L.S, L.tq, C_l, d_dens, vd,
                               vb, de, dd, dts, add);
        key_d = L.st.tp.idx[0];
        if (c.baked) key_b = L.tq.idx[0];
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) vd[k] = vb[k] = 0.0f;
      }
      if (c.baked) {
        // A lane without a lit step scatters nothing into the baked grid.
        bool lit = false;
#pragma unroll
        for (int k = 0; k < 8; ++k) lit = lit || vb[k] != 0.0f;
        if (!lit) key_b = -1 - gl;
        if (__any_sync(gmask, lit)) {
          group_deposit<G>(gmask, gl, shift, key_b, L.tq.idx, vb, d_baked, add);
        }
      }
      group_deposit<G>(gmask, gl, shift, key_d, L.st.tp.idx, vd, d_dens, add);
      was_in = was_in || sp.start < sp.end;
      if (sp.ended) break;
    }
  }
  // The group's sums, lane 0 writing.
  group_sum3<G>(gr, de);
  group_sum3<G>(gr, dd);
  group_sum3<G>(gr, dts);
  if (gl == 0) {
    for (int a = 0; a < 3; ++a) {
      d_entry[3 * r + a] = de[a];
      d_dirs[3 * r + a] = dd[a];
      if (d_ts != nullptr) d_ts[3 * r + a] = dts[a];
    }
    d_phase[r] = dP * g;
  }
}

template <int G>
__global__ void __launch_bounds__(kDiffThreads) march_bwd_lanes_kernel(
    const float* __restrict__ dens, const float* __restrict__ baked,
    const float* __restrict__ to_sun, ds::diff::MarchConsts c, const float* __restrict__ entry,
    const float* __restrict__ dirs, const float* __restrict__ phase,
    const uint8_t* __restrict__ hit, const float* __restrict__ rad,
    const float* __restrict__ g_rad, int64_t n, float* d_dens, float* d_baked, float* d_entry,
    float* d_dirs, float* d_phase, float* d_ts) {
  march_bwd_lanes<G>(dens, baked, to_sun, c, entry, dirs, phase, hit, rad, g_rad, n, d_dens,
                     d_baked, d_entry, d_dirs, d_phase, d_ts, ds::diff::AddTo());
}

// K8b's adjoint with G lanes a ray (ds_diff_march_bwd's arguments).
template <int G>
static int march_bwd_lanes_launch(const float* dens, const float* baked, const float* to_sun,
                                  int nx, int ny, int nz, const float* consts, int n_steps,
                                  int sun_steps, const float* entry, const float* dirs,
                                  const float* phase, const uint8_t* hit, const float* rad,
                                  const float* g_rad, int64_t n, float* d_dens, float* d_baked,
                                  float* d_entry, float* d_dirs, float* d_phase, float* d_ts,
                                  void* stream) {
  if (n <= 0) return 0;
  const ds::diff::MarchConsts c =
      ds::diff::march_consts(nx, ny, nz, consts, n_steps, sun_steps, baked != nullptr);
  const unsigned blocks = (unsigned)((n * G + kDiffThreads - 1) / kDiffThreads);
  march_bwd_lanes_kernel<G><<<blocks, kDiffThreads, 0, (cudaStream_t)stream>>>(
      dens, baked, to_sun, c, entry, dirs, phase, hit, rad, g_rad, n, d_dens, d_baked, d_entry,
      d_dirs, d_phase, d_ts);
  return (int)cudaGetLastError();
}

extern "C" {

// The card's thread slots (its SMs x 2048).
static int64_t thread_slots() {
  static int64_t slots = 0;
  if (slots == 0) {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    int per_sm = 0;
    cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, device);
    slots = (int64_t)sms * per_sm > 0 ? (int64_t)sms * per_sm : 1;
  }
  return slots;
}

// K8a's voxels a thread; K8b's adjoint's lanes a ray for n rays: 32 where
// n x 32 threads fit the card's thread slots, else 8.
int ds_adjoint_voxels() { return ds::diff::kAdjVoxels; }
int ds_diff_lanes(int64_t n) {
  return n * ds::diff::kDiffLanesFew <= thread_slots() ? ds::diff::kDiffLanesFew
                                                       : ds::diff::kDiffLanes;
}

// K8b's forward's lanes a ray for n rays: 32 where n x 32 threads fill at
// most half the card's thread slots, 16 where n x 16 fit them, else 8.
int ds_diff_forward_lanes(int64_t n) {
  if (2 * n * 32 <= thread_slots()) return 32;
  return n * 16 <= thread_slots() ? 16 : 8;
}

// K8a's light-gradient partial rows for an [nz, ny, nx] grid.
int64_t ds_bake_adjoint_blocks(int nx, int ny, int nz) {
  return ds::diff::row_launch(nx, ny, nz, ds::diff::kAdjVoxels).partials;
}

// K8a.  dens, trans, gbar: [nz * ny * nx] float32; d_dens: float64,
// zeroed by the caller and added to; consts as ds_bake's (bbox[3],
// light_dir[3], step, dm, max_dim); partials: float64
// [ds_bake_adjoint_blocks][3].
int ds_bake_adjoint(const float* dens, int nx, int ny, int nz, const float* consts,
                    int n_steps, const float* trans, const float* gbar, double* d_dens,
                    double* partials, void* stream) {
  return bake_adjoint_rows<ds::diff::kAdjVoxels>(
      dens, nx, ny, nz, consts, n_steps, trans, gbar, d_dens, partials, stream);
}

// K8b forward.  baked: the in-scatter grid (NULL: the sun march from
// to_sun[3]); consts: bbox[3], step, dm, sun_ratio; entry, dirs: [n][3];
// phase: [n]; hit: [n] (a ray that misses writes 0); rad: [n]; steps: NULL
// or [n][3] (steps in the box, steps with sigma != 0, the sun march's
// samples in the box at those steps: 0 baked).  ds_diff_forward_lanes(n)
// lanes a ray.
int ds_diff_march(const float* dens, const float* baked, const float* to_sun, int nx, int ny,
                  int nz, const float* consts, int n_steps, int sun_steps, const float* entry,
                  const float* dirs, const float* phase, const uint8_t* hit, int64_t n,
                  float* rad, int* steps, void* stream) {
#define DS_FWD(G)                                                                        \
  march_lanes_launch<G>(dens, baked, to_sun, nx, ny, nz, consts, n_steps, sun_steps, entry, \
                        dirs, phase, hit, n, rad, steps, stream)
  switch (ds_diff_forward_lanes(n)) {
    case 32: return DS_FWD(32);
    case 16: return DS_FWD(16);
    default: return DS_FWD(8);
  }
#undef DS_FWD
}

// K8b backward: d_dens (and d_baked) zeroed by the caller and added to;
// d_entry, d_dirs (and d_ts, pointwise): [n][3]; d_phase: [n].
int ds_diff_march_bwd(const float* dens, const float* baked, const float* to_sun, int nx,
                      int ny, int nz, const float* consts, int n_steps, int sun_steps,
                      const float* entry, const float* dirs, const float* phase,
                      const uint8_t* hit, const float* rad, const float* g_rad, int64_t n,
                      float* d_dens, float* d_baked, float* d_entry, float* d_dirs,
                      float* d_phase, float* d_ts, void* stream) {
  if (ds_diff_lanes(n) == ds::diff::kDiffLanes) {
    return march_bwd_lanes_launch<ds::diff::kDiffLanes>(
        dens, baked, to_sun, nx, ny, nz, consts, n_steps, sun_steps, entry, dirs, phase, hit,
        rad, g_rad, n, d_dens, d_baked, d_entry, d_dirs, d_phase, d_ts, stream);
  }
  return march_bwd_lanes_launch<ds::diff::kDiffLanesFew>(
      dens, baked, to_sun, nx, ny, nz, consts, n_steps, sun_steps, entry, dirs, phase, hit, rad,
      g_rad, n, d_dens, d_baked, d_entry, d_dirs, d_phase, d_ts, stream);
}

// The sun march from pos[n][3] toward to_sun[3], a thread a point; consts:
// bbox[3], step, dm; steps: NULL or [n] (each point's samples in the box).
int ds_sun_march(const float* dens, const float* to_sun, int nx, int ny, int nz,
                 const float* consts, int n_steps, const float* pos, int64_t n, float* out,
                 int* steps, void* stream) {
  return sun_march_launch(dens, to_sun, nx, ny, nz, consts, n_steps, pos, n, out, steps, stream);
}

// Its adjoint, a thread a point: d_dens zeroed by the caller and added to;
// d_pos, d_ts: [n][3].
int ds_sun_march_bwd(const float* dens, const float* to_sun, int nx, int ny, int nz,
                     const float* consts, int n_steps, const float* pos, const float* trans,
                     const float* g_trans, int64_t n, float* d_dens, float* d_pos, float* d_ts,
                     void* stream) {
  return sun_march_bwd_launch(dens, to_sun, nx, ny, nz, consts, n_steps, pos, trans, g_trans, n,
                              d_dens, d_pos, d_ts, stream);
}

}  // extern "C"

#endif  // DS_HOST_EMULATION
