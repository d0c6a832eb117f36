// K4: the path tracer's bounce loop, a persistent kernel whose warps take
// (pixel, sample) work items from a queue and march them kLookahead steps
// at a time.
//
// Replaces the XLA loops of deepestscatter_tpu/render/pathtracer.py::
// _scatter_loop_deferred (line 73) and _scatter_loop (line 671), as
// render_subframe, trace_hit_radiance and trace_tick_moments drive them,
// with the estimator of the oracle loop _scatter_loop (march_deferred=False,
// lines 671-845) and single scatter as trace_hit_radiance runs it
// (lines 956-972).
//
// Per pixel with hit[r] set, for sample k = 0 .. n_samples-1:
//   seed = seed_base ^ ((sub_first + k) * 0x9E3779B1)
//   the sample starts at the box entry; SUN_MULTIPLE_SCATTER first redraws
//   the direction around the pixel's ray (counters 0, 1); od is drawn at
//   counter 4 * depth (counter 0 for single scatter); then per step:
//   pos += dir * step, sigma = trilinear(density) * dm,
//   T *= exp(-sigma * step).  The first step with od > T scatters at
//   pos - dir * log(od / T) / sigma: inside the box it adds NEE (phase at
//   the cosine to the sun x baked sun T x sun solid-angle ratio x light x
//   weight; the full Mie phase at depth 1 of the all-scatter mode, else the
//   chopped phase) and draws the next direction (inverse-CDF cos theta at
//   counter +1, azimuth at +2, from_onb, normalize); optional roulette at
//   +3.  A sample ends on leaving the box (+-0.01 margin; with sample_sky
//   it then adds sky gradient + sun disc at depth 1, times the weight), at
//   max_depth bounces, by roulette, after its single scatter, or after
//   max_steps steps, where it is cut.  Every sample is folded into the
//   pixel's Welford triple in sample order (progressive.cu:17-27).
//   pathtrace_pixel below states this as a loop over one pixel's samples;
//   the kernel computes the same values in another order.
//
// The step lattice is the oracle's: no AABB jump and no empty-cell skip
// (both move positions at the ulp).  Float expressions follow the plain
// version (render/pathtracer.py::scatter_loop_plain) term by term; the
// build uses -fmad=false.
//
// Bound on the card: the density and in-scatter textures (16.7 MB each at
// 256^3 uint8) stay in the 50 MB L2; ~80 float operations a march step and
// ~300 an in-box scatter make the operation bound (0.198 ms for the 512^2,
// two-subframe tick at 256^3: 159.9 M steps, 1.70 M scatters).
//
// What held the first design back (one thread per pixel over its samples,
// 128-thread blocks, 72 registers; 6.105 ms a tick at 256^3 on an H100 at
// 700 W, 31x the bound):
//   - latency: each step was one dependent chain (position, three
//     divisions, cell math, eight int64-indexed taps, weighted sum, expf,
//     compare), at about 7 warps a scheduler, about 5x slower than its
//     issue rate;
//   - SIMT efficiency 0.76 (the tick's per-pixel step counts in groups of
//     32): a warp waited for its longest pixel (up to 3,403 steps a tick
//     against a mean of 743 over hit pixels).
// The design here:
//   1. Lookahead march (march_chunk): a free flight is walked K steps at a
//      time.  The density and exp(-sigma * step) of a step do
//      not depend on the step before; only T *= e and the od > T test
//      carry.  A first pass computes the chunk's K positions (the same
//      incremental pos + dir * step), taps and factors as K independent
//      chains; a second pass applies T *= e_k and the test in order.  The
//      first crossing takes its step's values and drops the rest of the
//      chunk, which counts only the steps taken; box exits and the step
//      cap cut it the same way.  Every value equals the step-by-step loop.
//   2. Persistent threads with lane regeneration (pathtrace_items_kernel):
//      the grid fills the card once (occupancy x SMs); a lane whose sample
//      ends takes the next (pixel, sample) item in the same warp step
//      (ballot, one atomicAdd of the popcount by the leader, shuffle of
//      the base).  Items are sample-major, pixel-minor, so a warp's fresh
//      first flights are neighbours.  A pixel without a box hit is skipped.
//   3. Fold in sample order: each sample writes radiance, steps and in-box
//      scatters to a per-sample record [n_samples, N]; a second small
//      launch over the pixels (fold_kernel) folds them in sample order
//      with the expressions of the per-pixel loop.  Chosen over folding in
//      the sample that completes a pixel: it needs no arrival counters or
//      fences and reads the records once, coalesced.  They take 20 bytes a
//      (pixel, sample): 10.5 MB for a 512^2 two-subframe tick, growing
//      linearly with the samples of one launch.
//   4. Index math in 32 bits (common.cuh::trilinear_strided): the cell's
//      base offset once a step, the taps at strides 1, nx and nx * ny.
//      The wrapper raises for textures of 2^31 elements or more.
// The texture layout stays [Z, Y, X].  Texture coordinates divide by bbox
// as a product where bbox is a power of two (common.cuh::div_exact; 1 in a
// cubic grid), which keeps every value.
// Measured (probes/march_variants.py, 256^3 tick, H100 at 700 W): the
// queue is ~10 % faster than one thread per pixel with the same march
// (5.15 against 5.70 ms at K = 1), at 56 registers against 64, although
// its SIMT efficiency is lower (0.73 against 0.76): a tick gives each of
// the ~150 k resident lanes only ~3 samples and the warps' last samples
// form a tail.  The 32-bit taps and exact divisions gave ~2 %.  In the
// queue K = 1 and K = 2 cannot be told apart from the noise of a run;
// K = 4 and 8 are slower (registers, spills, dropped steps): the loop is
// not bound by the latency of its chain.  K = 2 is kept.  Reading a uint8
// row's two x taps with one aligned 32-bit load was slower at every K: the
// march is not bound by its count of load instructions either.
#include "common.cuh"

namespace ds {

// Steps of one lookahead chunk.
constexpr int kLookahead = 2;

struct PtConsts {
  float bbox[3];
  float inv_bbox[3];  // pow2_recip(bbox): texture coordinates as products
  float step;
  float dm;  // density multiplier
  float light[3];  // light_dir (points from the sun)
  float radiance[3];
  float sun_ratio;
  float sun_cos_half;
  float rr_q;  // roulette survival probability
  float sky[3];
  float ground[3];
  int max_steps;  // per-sample step cap
  int max_depth;
  int rr_start;  // 0 = no roulette
  int n_phase;
  int n_inv;
  int flags;
};

enum : int { kSingle = 1, kResample = 2, kChopped1 = 4, kSky = 8 };


// float32(2 pi), as torch rounds the Python constant 2 * math.pi.
constexpr float kTwoPi = (float)(2.0 * 3.141592653589793);

__device__ __forceinline__ bool in_box(float x, float y, float z, const float* b) {
  return x >= -0.01f && x <= b[0] + 0.01f && y >= -0.01f && y <= b[1] + 0.01f &&
         z >= -0.01f && z <= b[2] + 0.01f;
}

// Lerp cell of t = u * n - 0.5 (ops/phase.py::_row_index).
__device__ __forceinline__ int row_index(float t, int n, float& frac) {
  const float t0 = floorf(t);
  frac = t0 < 0.0f ? 0.0f : t - t0;
  int i = (int)fminf(fmaxf(t0, -1.0f), (float)n);
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

__device__ __forceinline__ float cos_to_sun(const PtConsts& c, float dx, float dy,
                                            float dz) {
  return ((-c.light[0]) * dx + (-c.light[1]) * dy) + (-c.light[2]) * dz;
}

// render/pathtracer.py::new_direction: sample_cos_theta_fast,
// uniform_on_sphere_circle, from_onb (make_onb around d), normalize.
__device__ __forceinline__ void new_direction(const float* __restrict__ inv, int n_inv,
                                              float u_cdf, float u_phi, float& dx,
                                              float& dy, float& dz) {
  float frac;
  const int i0 = row_index(u_cdf * (float)n_inv - 0.5f, n_inv, frac);
  const float m = inv[2 * i0] * (1.0f - frac) + inv[2 * i0 + 1] * frac;
  const float ct = 2.0f * m - 1.0f;
  const float phi = u_phi * kTwoPi;
  const float st = sqrtf(fmaxf(1.0f - ct * ct, 0.0f));
  const float lx = st * cosf(phi), ly = st * sinf(phi), lz = ct;
  const float sign = dz >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + dz);
  const float b = (dx * dy) * a;
  const float tx = 1.0f + (sign * (dx * dx)) * a, ty = sign * b, tz = (-sign) * dx;
  const float bx = b, by = sign + (dy * dy) * a, bz = -dy;
  const float ox = (lx * tx + ly * bx) + lz * dx;
  const float oy = (lx * ty + ly * by) + lz * dy;
  const float oz = (lx * tz + ly * bz) + lz * dz;
  const float len = sqrtf((ox * ox + oy * oy) + oz * oz);
  dx = ox / len;
  dy = oy / len;
  dz = oz / len;
}

// Sky gradient, plus the sun disc at depth 1, times the path weight.
__device__ __forceinline__ void add_sky_exit(const PtConsts& c, float dx, float dy,
                                             float dz, int depth, float weight,
                                             float* rad) {
  const float t = fminf(fmaxf((dy + 0.5f) / 1.5f, 0.0f), 1.0f);
  const bool sun = depth == 1 && cos_to_sun(c, dx, dy, dz) > c.sun_cos_half;
  for (int i = 0; i < 3; ++i) {
    const float sky = c.ground[i] * (1.0f - t) + c.sky[i] * t;
    rad[i] = rad[i] + (sky + (sun ? c.radiance[i] : 0.0f)) * weight;
  }
}

// One sample in flight.
struct Sample {
  float px, py, pz;  // position (local coordinates)
  float dx, dy, dz;
  float trans, od, weight;
  float rad[3];
  uint32_t seed, id;
  int depth;
  int steps;  // march steps of this sample
  int bounces;  // its free flights that ended in the box
};

// A sample from the box entry (ex, ey, ez) along (dx, dy, dz).
__device__ __forceinline__ void begin_sample(Sample& S, const PtConsts& c,
                                             const float* __restrict__ inv, uint32_t seed,
                                             uint32_t id, float ex, float ey, float ez,
                                             float dx, float dy, float dz) {
  S.px = ex;
  S.py = ey;
  S.pz = ez;
  S.dx = dx;
  S.dy = dy;
  S.dz = dz;
  for (int i = 0; i < 3; ++i) S.rad[i] = 0.0f;
  S.seed = seed;
  S.id = id;
  S.steps = 0;
  S.bounces = 0;
  if (c.flags & kResample) {
    new_direction(inv, c.n_inv, hash_uniform(seed, id, 0u), hash_uniform(seed, id, 1u),
                  S.dx, S.dy, S.dz);
  }
  S.depth = 1;
  S.weight = 1.0f;
  S.trans = 1.0f;
  S.od = hash_uniform(seed, id, (c.flags & kSingle) ? 0u : 4u);
}

// A march step to (ax, ay, az) whose transmittance tn stayed at or above
// od: moves there.  True where the sample ends (it left the box, or the
// oracle's depth test, which only bites at max_depth 1).
__device__ __forceinline__ bool free_step(Sample& S, const PtConsts& c, float ax, float ay,
                                          float az, float tn) {
  S.px = ax;
  S.py = ay;
  S.pz = az;
  S.trans = tn;
  if (!in_box(ax, ay, az, c.bbox)) {
    if (c.flags & kSky) add_sky_exit(c, S.dx, S.dy, S.dz, S.depth, S.weight, S.rad);
    return true;
  }
  return !(c.flags & kSingle) && S.depth >= c.max_depth;
}

// A march step to (ax, ay, az) of density `density` whose transmittance tn
// fell below od: the free flight ends there.  Adds NEE at an in-box
// scatter point and starts the next flight.  True where the sample ends.
template <typename T>
__device__ __forceinline__ bool scatter(Sample& S, const T* __restrict__ insc, int nx,
                                        int ny, int nz, const float* __restrict__ eval_rows,
                                        const float* __restrict__ inv, const PtConsts& c,
                                        float ax, float ay, float az, float density,
                                        float tn) {
  const bool single = c.flags & kSingle;
  const float back =
      logf(fmaxf(S.od, 1e-20f) / fmaxf(tn, 1e-20f)) / fmaxf(density, 1e-10f);
  const float sx = ax - S.dx * back, sy = ay - S.dy * back, sz = az - S.dz * back;
  const bool inb = in_box(sx, sy, sz, c.bbox);
  if (inb) {
    ++S.bounces;
    const bool chopped = S.depth != 1 || (c.flags & kChopped1);
    float frac;
    const float cosl = cos_to_sun(c, S.dx, S.dy, S.dz);
    const int i0 = row_index(((cosl + 1.0f) * 0.5f) * (float)c.n_phase - 0.5f,
                             c.n_phase, frac);
    const int col = chopped ? 2 : 0;
    const float p =
        eval_rows[4 * i0 + col] * (1.0f - frac) + eval_rows[4 * i0 + col + 1] * frac;
    const float sun_t = trilinear_strided(insc, nx, ny, nz,
                                          div_exact(sx, c.bbox[0], c.inv_bbox[0]),
                                          div_exact(sy, c.bbox[1], c.inv_bbox[1]),
                                          div_exact(sz, c.bbox[2], c.inv_bbox[2]));
    const float scale = (p * sun_t) * c.sun_ratio;
    for (int i = 0; i < 3; ++i) S.rad[i] = S.rad[i] + (c.radiance[i] * scale) * S.weight;
  }
  if (single) return true;
  const uint32_t ctr = (uint32_t)S.depth * 4u;
  const int new_depth = S.depth + 1;
  if (inb) {
    new_direction(inv, c.n_inv, hash_uniform(S.seed, S.id, ctr + 1u),
                  hash_uniform(S.seed, S.id, ctr + 2u), S.dx, S.dy, S.dz);
  }
  S.px = sx;
  S.py = sy;
  S.pz = sz;
  S.trans = 1.0f;
  S.od = hash_uniform(S.seed, S.id, (uint32_t)new_depth * 4u);
  bool end = new_depth >= c.max_depth;
  if (!inb) {
    if (c.flags & kSky) add_sky_exit(c, S.dx, S.dy, S.dz, S.depth, S.weight, S.rad);
    end = true;
  }
  if (c.rr_start > 0 && new_depth >= c.rr_start) {
    if (hash_uniform(S.seed, S.id, ctr + 3u) >= c.rr_q) {
      end = true;
    } else {
      S.weight = S.weight / c.rr_q;
    }
  }
  S.depth = new_depth;
  return end;
}

// The sample to its end, one march step at a time.
template <typename T>
__device__ __forceinline__ void trace_sample(Sample& S, const T* __restrict__ dens,
                                             const T* __restrict__ insc, int nx, int ny,
                                             int nz, const float* __restrict__ eval_rows,
                                             const float* __restrict__ inv,
                                             const PtConsts& c) {
  while (S.steps < c.max_steps) {
    const float ax = S.px + S.dx * c.step, ay = S.py + S.dy * c.step,
                az = S.pz + S.dz * c.step;
    const float density =
        trilinear(dens, nx, ny, nz, ax / c.bbox[0], ay / c.bbox[1], az / c.bbox[2]) *
        c.dm;
    const float tn = S.trans * expf(-density * c.step);
    ++S.steps;
    if (!(S.od > tn)) {
      if (free_step(S, c, ax, ay, az, tn)) return;
      continue;
    }
    if (scatter(S, insc, nx, ny, nz, eval_rows, inv, c, ax, ay, az, density, tn)) return;
  }
}

// Up to K march steps of the sample with the same values as K rounds of
// trace_sample's loop: the K steps' densities and factors first, as
// independent chains, then the transmittance updates and tests in order
// (a loop without early exits, so that it unrolls and the arrays stay in
// registers).  True where the sample ended.
template <int K, typename T>
__device__ __forceinline__ bool march_chunk(Sample& S, const T* __restrict__ dens,
                                            const T* __restrict__ insc, int nx, int ny,
                                            int nz, const float* __restrict__ eval_rows,
                                            const float* __restrict__ inv,
                                            const PtConsts& c) {
  float dens_k[K], e_k[K];
  float qx = S.px, qy = S.py, qz = S.pz;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    qx = qx + S.dx * c.step;
    qy = qy + S.dy * c.step;
    qz = qz + S.dz * c.step;
    dens_k[k] = trilinear_strided(dens, nx, ny, nz, div_exact(qx, c.bbox[0], c.inv_bbox[0]),
                                  div_exact(qy, c.bbox[1], c.inv_bbox[1]),
                                  div_exact(qz, c.bbox[2], c.inv_bbox[2])) *
                c.dm;
    e_k[k] = expf(-dens_k[k] * c.step);
  }
  float ax = 0.0f, ay = 0.0f, az = 0.0f, tn = 0.0f, density = 0.0f;
  int state = 0;  // 0 marching, 1 the sample ended, 2 od crossed
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (state == 0) {
      if (S.steps >= c.max_steps) {
        state = 1;
      } else {
        ax = S.px + S.dx * c.step;
        ay = S.py + S.dy * c.step;
        az = S.pz + S.dz * c.step;
        tn = S.trans * e_k[k];
        ++S.steps;
        if (S.od > tn) {
          density = dens_k[k];
          state = 2;
        } else if (free_step(S, c, ax, ay, az, tn)) {
          state = 1;
        }
      }
    }
  }
  if (state == 2) return scatter(S, insc, nx, ny, nz, eval_rows, inv, c, ax, ay, az, density, tn);
  return state == 1;
}

// Welford update of (mean, m2, cnt) with one sample's radiance.
__device__ __forceinline__ void welford_add(float* mean, float* m2, float& cnt,
                                            const float* rad) {
  const float cnt_new = cnt + 1.0f;
  const float nsafe = fmaxf(cnt_new, 1.0f);
  for (int i = 0; i < 3; ++i) {
    const float delta = rad[i] - mean[i];
    const float mean_new = mean[i] + delta / nsafe;
    m2[i] = m2[i] + delta * (rad[i] - mean_new);
    mean[i] = mean_new;
  }
  cnt = cnt_new;
}

// The estimator as one loop over pixel r's samples, one step at a time.
template <typename T>
__device__ __forceinline__ void pathtrace_pixel(
    int64_t r, const T* __restrict__ dens, const T* __restrict__ insc, int nx, int ny,
    int nz, const float* __restrict__ eval_rows, const float* __restrict__ inv,
    const float* __restrict__ entry, const float* __restrict__ dirs,
    const uint8_t* __restrict__ hit, const int64_t* __restrict__ ray_ids,
    const PtConsts& c, uint32_t seed_base, uint32_t sub_first, int n_samples,
    float* __restrict__ mean_out, float* __restrict__ m2_out,
    float* __restrict__ count_out, int64_t* __restrict__ work_out) {
  float mean[3] = {0.0f, 0.0f, 0.0f}, m2[3] = {0.0f, 0.0f, 0.0f};
  float cnt = 0.0f;
  int64_t steps = 0, bounces = 0;
  if (hit[r]) {
    const float ex = entry[3 * r], ey = entry[3 * r + 1], ez = entry[3 * r + 2];
    const bool entry_in = in_box(ex, ey, ez, c.bbox);
    for (int k = 0; k < n_samples; ++k) {
      const uint32_t seed = seed_base ^ ((sub_first + (uint32_t)k) * 0x9E3779B1u);
      float rad[3] = {0.0f, 0.0f, 0.0f};
      if (entry_in) {
        Sample S;
        begin_sample(S, c, inv, seed, (uint32_t)ray_ids[r], ex, ey, ez, dirs[3 * r],
                     dirs[3 * r + 1], dirs[3 * r + 2]);
        trace_sample(S, dens, insc, nx, ny, nz, eval_rows, inv, c);
        for (int i = 0; i < 3; ++i) rad[i] = S.rad[i];
        steps += S.steps;
        bounces += S.bounces;
      }
      welford_add(mean, m2, cnt, rad);
    }
  }
  for (int i = 0; i < 3; ++i) {
    mean_out[3 * r + i] = mean[i];
    m2_out[3 * r + i] = m2[i];
  }
  count_out[r] = cnt;
  work_out[2 * r] = steps;
  work_out[2 * r + 1] = bounces;
}

// The per-sample record of item `item` (= sample * N + pixel).
__device__ __forceinline__ void write_record(const Sample& S, int64_t item,
                                             float* __restrict__ rec_rad,
                                             int32_t* __restrict__ rec_work) {
  for (int i = 0; i < 3; ++i) rec_rad[3 * item + i] = S.rad[i];
  rec_work[2 * item] = S.steps;
  rec_work[2 * item + 1] = S.bounces;
}

// Starts work item `item` (sample item / n of pixel item % n).  True where
// the sample has steps to march.  A pixel without a box hit has no
// records; a sample whose entry lies outside the box gets a zero record.
__device__ __forceinline__ bool begin_item(
    Sample& S, int64_t item, int64_t n, const float* __restrict__ entry,
    const float* __restrict__ dirs, const uint8_t* __restrict__ hit,
    const int64_t* __restrict__ ray_ids, const float* __restrict__ inv,
    const PtConsts& c, uint32_t seed_base, uint32_t sub_first,
    float* __restrict__ rec_rad, int32_t* __restrict__ rec_work) {
  const int64_t r = item % n;
  const uint32_t k = (uint32_t)(item / n);
  if (!hit[r]) return false;
  const float ex = entry[3 * r], ey = entry[3 * r + 1], ez = entry[3 * r + 2];
  const uint32_t seed = seed_base ^ ((sub_first + k) * 0x9E3779B1u);
  begin_sample(S, c, inv, seed, (uint32_t)ray_ids[r], ex, ey, ez, dirs[3 * r],
               dirs[3 * r + 1], dirs[3 * r + 2]);
  if (in_box(ex, ey, ez, c.bbox)) return true;
  write_record(S, item, rec_rad, rec_work);  // begin_sample zeroed it
  return false;
}

// Pixel r's records folded in sample order (the expressions of
// pathtrace_pixel); zeros where the pixel has no box hit.
__device__ __forceinline__ void fold_pixel(int64_t r, int64_t n, int n_samples,
                                           const uint8_t* __restrict__ hit,
                                           const float* __restrict__ rec_rad,
                                           const int32_t* __restrict__ rec_work,
                                           float* __restrict__ mean_out,
                                           float* __restrict__ m2_out,
                                           float* __restrict__ count_out,
                                           int64_t* __restrict__ work_out) {
  float mean[3] = {0.0f, 0.0f, 0.0f}, m2[3] = {0.0f, 0.0f, 0.0f};
  float cnt = 0.0f;
  int64_t steps = 0, bounces = 0;
  if (hit[r]) {
    for (int k = 0; k < n_samples; ++k) {
      const int64_t i = (int64_t)k * n + r;
      const float rad[3] = {rec_rad[3 * i], rec_rad[3 * i + 1], rec_rad[3 * i + 2]};
      welford_add(mean, m2, cnt, rad);
      steps += rec_work[2 * i];
      bounces += rec_work[2 * i + 1];
    }
  }
  for (int i = 0; i < 3; ++i) {
    mean_out[3 * r + i] = mean[i];
    m2_out[3 * r + i] = m2[i];
  }
  count_out[r] = cnt;
  work_out[2 * r] = steps;
  work_out[2 * r + 1] = bounces;
}

// consts: bbox[3], step, dm, light_dir[3], light_radiance[3],
// sun_solid_angle_ratio, sun_cos_half_angle, rr_survival, sky[3] (16 + 3
// host floats); ground[3].
inline PtConsts pt_consts(const float* k, const float* ground, int max_steps,
                          int max_depth, int rr_start, int n_phase, int n_inv,
                          int flags) {
  PtConsts c;
  for (int i = 0; i < 3; ++i) {
    c.bbox[i] = k[i];
    c.inv_bbox[i] = pow2_recip(k[i]);
    c.light[i] = k[5 + i];
    c.radiance[i] = k[8 + i];
    c.sky[i] = k[14 + i];
    c.ground[i] = ground[i];
  }
  c.step = k[3];
  c.dm = k[4];
  c.sun_ratio = k[11];
  c.sun_cos_half = k[12];
  c.rr_q = k[13];
  c.max_steps = max_steps;
  c.max_depth = max_depth;
  c.rr_start = rr_start;
  c.n_phase = n_phase;
  c.n_inv = n_inv;
  c.flags = flags;
  return c;
}

}  // namespace ds

#ifndef DS_HOST_EMULATION

constexpr int kPtThreads = 128;
constexpr unsigned kFullMask = 0xffffffffu;

// counters[0]: the item queue's head (zeroed before the launch);
// counters[1]: the warps' step slots (K a loop iteration), added once per
// warp at exit.
template <int K, typename T>
__global__ void __launch_bounds__(kPtThreads) pathtrace_items_kernel(
    const T* __restrict__ dens, const T* __restrict__ insc, int nx, int ny, int nz,
    const float* __restrict__ eval_rows, const float* __restrict__ inv,
    const float* __restrict__ entry, const float* __restrict__ dirs,
    const uint8_t* __restrict__ hit, const int64_t* __restrict__ ray_ids, int64_t n,
    int64_t n_items, ds::PtConsts c, uint32_t seed_base, uint32_t sub_first,
    float* __restrict__ rec_rad, int32_t* __restrict__ rec_work,
    unsigned long long* __restrict__ counters) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  ds::Sample S;
  int64_t item = 0;
  bool have = false, drained = false;
  unsigned long long iters = 0;
  for (;;) {
    // Lanes without a sample take the next items, one atomicAdd a warp.
    for (;;) {
      const bool need = !have && !drained;
      const unsigned want = __ballot_sync(kFullMask, need);
      if (want == 0u) break;
      const int leader = __ffs(want) - 1;
      unsigned long long base = 0;
      if (lane == leader) base = atomicAdd(&counters[0], (unsigned long long)__popc(want));
      base = __shfl_sync(kFullMask, base, leader);
      if (need) {
        item = (int64_t)(base + (unsigned long long)__popc(want & below));
        if (item >= n_items) {
          drained = true;
        } else {
          have = ds::begin_item(S, item, n, entry, dirs, hit, ray_ids, inv, c, seed_base,
                                sub_first, rec_rad, rec_work);
        }
      }
    }
    if (!__any_sync(kFullMask, have)) break;
    ++iters;
    if (have && ds::march_chunk<K>(S, dens, insc, nx, ny, nz, eval_rows, inv, c)) {
      ds::write_record(S, item, rec_rad, rec_work);
      have = false;
    }
  }
  if (lane == 0) atomicAdd(&counters[1], iters * K);
}

__global__ void __launch_bounds__(256) fold_kernel(
    const uint8_t* __restrict__ hit, int64_t n, int n_samples,
    const float* __restrict__ rec_rad, const int32_t* __restrict__ rec_work,
    float* __restrict__ mean_out, float* __restrict__ m2_out,
    float* __restrict__ count_out, int64_t* __restrict__ work_out) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  ds::fold_pixel(r, n, n_samples, hit, rec_rad, rec_work, mean_out, m2_out, count_out,
                 work_out);
}

template <int K, typename T>
static int launch_items(const T* dens, const T* insc, int nx, int ny, int nz,
                        const float* eval_rows, const float* inv, const float* entry,
                        const float* dirs, const uint8_t* hit, const int64_t* ray_ids,
                        int64_t n, int64_t n_items, const ds::PtConsts& c,
                        uint32_t seed_base, uint32_t sub_first, float* rec_rad,
                        int32_t* rec_work, unsigned long long* counters, cudaStream_t s) {
  static int per_sm = 0;  // resident blocks a SM, the same on every call
  if (per_sm == 0) {
    int b = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, pathtrace_items_kernel<K, T>, kPtThreads, 0);
    if (e != cudaSuccess) return (int)e;
    per_sm = b > 0 ? b : 1;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int64_t needed = (n_items + kPtThreads - 1) / kPtThreads;
  const int64_t full = (int64_t)per_sm * sms;
  const unsigned blocks = (unsigned)(needed < full ? needed : full);
  pathtrace_items_kernel<K, T><<<blocks, kPtThreads, 0, s>>>(
      dens, insc, nx, ny, nz, eval_rows, inv, entry, dirs, hit, ray_ids, n, n_items, c,
      seed_base, sub_first, rec_rad, rec_work, counters);
  return (int)cudaGetLastError();
}

// The item kernel at lookahead K, then the fold (ds_pathtrace's arguments).
template <int K>
static int pathtrace_queue(const void* dens, const void* insc, int is_u8, int nx, int ny,
                           int nz, const float* eval_rows, int n_phase, const float* inv_rows,
                           int n_inv, const float* entry, const float* dirs,
                           const uint8_t* hit, const int64_t* ray_ids, int64_t n,
                           const float* consts, const float* ground, int max_steps,
                           int max_depth, int rr_start, int flags, uint32_t seed_base,
                           uint32_t sub_first, int n_samples, float* rec_rad,
                           int32_t* rec_work, unsigned long long* counters, float* mean_out,
                           float* m2_out, float* count_out, int64_t* work_out,
                           void* stream) {
  if (n <= 0) return 0;
  const ds::PtConsts c =
      ds::pt_consts(consts, ground, max_steps, max_depth, rr_start, n_phase, n_inv, flags);
  const int64_t n_items = n * (int64_t)n_samples;
  cudaStream_t s = (cudaStream_t)stream;
  int err = (int)cudaMemsetAsync(counters, 0, 2 * sizeof(unsigned long long), s);
  if (err != 0) return err;
  if (is_u8) {
    err = launch_items<K, uint8_t>((const uint8_t*)dens, (const uint8_t*)insc, nx, ny, nz,
                                eval_rows, inv_rows, entry, dirs, hit, ray_ids, n, n_items,
                                c, seed_base, sub_first, rec_rad, rec_work, counters, s);
  } else {
    err = launch_items<K, float>((const float*)dens, (const float*)insc, nx, ny, nz,
                              eval_rows, inv_rows, entry, dirs, hit, ray_ids, n, n_items, c,
                              seed_base, sub_first, rec_rad, rec_work, counters, s);
  }
  if (err != 0) return err;
  fold_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      hit, n, n_samples, rec_rad, rec_work, mean_out, m2_out, count_out, work_out);
  return (int)cudaGetLastError();
}

// flags: 1 single scatter, 2 redraw the first direction per sample,
// 4 chopped phase at depth 1, 8 sample sky at box exits.  rec_rad
// [n_samples, n, 3] float32 and rec_work [n_samples, n, 2] int32 are the
// per-sample records; counters is 2 uint64 (zeroed here); work_out is
// [n, 2] int64 (steps, in-box scatters).  Returns the first CUDA error of
// the two launches, or 0.
extern "C" int ds_pathtrace(const void* dens, const void* insc, int is_u8, int nx,
                            int ny, int nz, const float* eval_rows, int n_phase,
                            const float* inv_rows, int n_inv, const float* entry,
                            const float* dirs, const uint8_t* hit,
                            const int64_t* ray_ids, int64_t n, const float* consts,
                            const float* ground, int max_steps, int max_depth,
                            int rr_start, int flags, uint32_t seed_base,
                            uint32_t sub_first, int n_samples, float* rec_rad,
                            int32_t* rec_work, unsigned long long* counters,
                            float* mean_out, float* m2_out, float* count_out,
                            int64_t* work_out, void* stream) {
  return pathtrace_queue<ds::kLookahead>(
      dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase, inv_rows, n_inv, entry, dirs, hit,
      ray_ids, n, consts, ground, max_steps, max_depth, rr_start, flags, seed_base,
      sub_first, n_samples, rec_rad, rec_work, counters, mean_out, m2_out, count_out,
      work_out, stream);
}

#endif  // DS_HOST_EMULATION
