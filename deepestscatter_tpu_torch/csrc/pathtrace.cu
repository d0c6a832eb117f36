// K4: the path tracer's bounce loop, one thread per pixel over its samples.
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
//
// The step lattice is the oracle's: no AABB jump and no empty-cell skip
// (both move positions at the ulp).  Float expressions follow the plain
// version (render/pathtracer.py::scatter_loop_plain) term by term; the
// build uses -fmad=false.
//
// Bound on the card: the density and in-scatter textures (16.7 MB each at
// 256^3 uint8) stay in the 50 MB L2, so the loop is a chain of dependent
// L2 gathers (8 taps a step) plus ~80 float operations a step and ~300 a
// bounce; operations are the roofline bound, gather latency and warp
// divergence the practical one (paths in one warp differ in length by
// orders of magnitude).  Design of this first version: one thread per
// pixel, so a pixel's next sample starts as soon as its last one ends
// (the JAX package's lane regeneration comes free); no compaction.
#include "common.cuh"

namespace ds {

struct PtConsts {
  float bbox[3];
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

// One sample from the box entry (px, py, pz) along (dx, dy, dz); adds its
// radiance to rad[3] and its steps and in-box scatters to the counts.
template <typename T>
__device__ __forceinline__ void trace_sample(
    const T* __restrict__ dens, const T* __restrict__ insc, int nx, int ny, int nz,
    const float* __restrict__ eval_rows, const float* __restrict__ inv,
    const PtConsts& c, uint32_t seed, uint32_t id, float px, float py, float pz,
    float dx, float dy, float dz, float* rad, int64_t& steps, int64_t& bounces) {
  const bool single = c.flags & kSingle;
  if (c.flags & kResample) {
    new_direction(inv, c.n_inv, hash_uniform(seed, id, 0u), hash_uniform(seed, id, 1u),
                  dx, dy, dz);
  }
  int depth = 1;
  float weight = 1.0f, trans = 1.0f;
  float od = hash_uniform(seed, id, single ? 0u : 4u);
  for (int s = 0; s < c.max_steps; ++s) {
    const float ax = px + dx * c.step, ay = py + dy * c.step, az = pz + dz * c.step;
    const float density =
        trilinear(dens, nx, ny, nz, ax / c.bbox[0], ay / c.bbox[1], az / c.bbox[2]) *
        c.dm;
    const float tn = trans * expf(-density * c.step);
    ++steps;
    if (!(od > tn)) {
      px = ax;
      py = ay;
      pz = az;
      trans = tn;
      if (!in_box(ax, ay, az, c.bbox)) {
        if (c.flags & kSky) add_sky_exit(c, dx, dy, dz, depth, weight, rad);
        return;
      }
      // The oracle's depth test (only bites at max_depth 1).
      if (!single && depth >= c.max_depth) return;
      continue;
    }
    const float back =
        logf(fmaxf(od, 1e-20f) / fmaxf(tn, 1e-20f)) / fmaxf(density, 1e-10f);
    const float sx = ax - dx * back, sy = ay - dy * back, sz = az - dz * back;
    const bool inb = in_box(sx, sy, sz, c.bbox);
    if (inb) {
      ++bounces;
      const bool chopped = depth != 1 || (c.flags & kChopped1);
      float frac;
      const float cosl = cos_to_sun(c, dx, dy, dz);
      const int i0 = row_index(((cosl + 1.0f) * 0.5f) * (float)c.n_phase - 0.5f,
                               c.n_phase, frac);
      const int col = chopped ? 2 : 0;
      const float p =
          eval_rows[4 * i0 + col] * (1.0f - frac) + eval_rows[4 * i0 + col + 1] * frac;
      const float sun_t =
          trilinear(insc, nx, ny, nz, sx / c.bbox[0], sy / c.bbox[1], sz / c.bbox[2]);
      const float scale = (p * sun_t) * c.sun_ratio;
      for (int i = 0; i < 3; ++i) rad[i] = rad[i] + (c.radiance[i] * scale) * weight;
    }
    if (single) return;
    const uint32_t ctr = (uint32_t)depth * 4u;
    const int new_depth = depth + 1;
    if (inb) {
      new_direction(inv, c.n_inv, hash_uniform(seed, id, ctr + 1u),
                    hash_uniform(seed, id, ctr + 2u), dx, dy, dz);
    }
    px = sx;
    py = sy;
    pz = sz;
    trans = 1.0f;
    od = hash_uniform(seed, id, (uint32_t)new_depth * 4u);
    bool end = new_depth >= c.max_depth;
    if (!inb) {
      if (c.flags & kSky) add_sky_exit(c, dx, dy, dz, depth, weight, rad);
      end = true;
    }
    if (c.rr_start > 0 && new_depth >= c.rr_start) {
      if (hash_uniform(seed, id, ctr + 3u) >= c.rr_q) {
        end = true;
      } else {
        weight = weight / c.rr_q;
      }
    }
    depth = new_depth;
    if (end) return;
  }
}

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
    const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
    const uint32_t id = (uint32_t)ray_ids[r];
    const bool entry_in = in_box(ex, ey, ez, c.bbox);
    for (int k = 0; k < n_samples; ++k) {
      const uint32_t seed = seed_base ^ ((sub_first + (uint32_t)k) * 0x9E3779B1u);
      float rad[3] = {0.0f, 0.0f, 0.0f};
      if (entry_in) {
        trace_sample(dens, insc, nx, ny, nz, eval_rows, inv, c, seed, id, ex, ey, ez,
                     dx, dy, dz, rad, steps, bounces);
      }
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

template <typename T>
__global__ void __launch_bounds__(128) pathtrace_kernel(
    const T* __restrict__ dens, const T* __restrict__ insc, int nx, int ny, int nz,
    const float* __restrict__ eval_rows, const float* __restrict__ inv,
    const float* __restrict__ entry, const float* __restrict__ dirs,
    const uint8_t* __restrict__ hit, const int64_t* __restrict__ ray_ids, int64_t n,
    ds::PtConsts c, uint32_t seed_base, uint32_t sub_first, int n_samples,
    float* __restrict__ mean_out, float* __restrict__ m2_out,
    float* __restrict__ count_out, int64_t* __restrict__ work_out) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  ds::pathtrace_pixel(r, dens, insc, nx, ny, nz, eval_rows, inv, entry, dirs, hit,
                      ray_ids, c, seed_base, sub_first, n_samples, mean_out, m2_out,
                      count_out, work_out);
}

// flags: 1 single scatter, 2 redraw the first direction per sample,
// 4 chopped phase at depth 1, 8 sample sky at box exits.  work_out is
// [n, 2] int64 (steps, in-box scatters).  Returns cudaGetLastError() after
// the launch.
extern "C" int ds_pathtrace(const void* dens, const void* insc, int is_u8, int nx,
                            int ny, int nz, const float* eval_rows, int n_phase,
                            const float* inv_rows, int n_inv, const float* entry,
                            const float* dirs, const uint8_t* hit,
                            const int64_t* ray_ids, int64_t n, const float* consts,
                            const float* ground, int max_steps, int max_depth,
                            int rr_start, int flags, uint32_t seed_base,
                            uint32_t sub_first, int n_samples, float* mean_out,
                            float* m2_out, float* count_out, int64_t* work_out,
                            void* stream) {
  if (n <= 0) return 0;
  const ds::PtConsts c =
      ds::pt_consts(consts, ground, max_steps, max_depth, rr_start, n_phase, n_inv, flags);
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_u8) {
    pathtrace_kernel<uint8_t><<<blocks, threads, 0, s>>>(
        (const uint8_t*)dens, (const uint8_t*)insc, nx, ny, nz, eval_rows, inv_rows,
        entry, dirs, hit, ray_ids, n, c, seed_base, sub_first, n_samples, mean_out,
        m2_out, count_out, work_out);
  } else {
    pathtrace_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)dens, (const float*)insc, nx, ny, nz, eval_rows, inv_rows, entry,
        dirs, hit, ray_ids, n, c, seed_base, sub_first, n_samples, mean_out, m2_out,
        count_out, work_out);
  }
  return (int)cudaGetLastError();
}

#endif  // DS_HOST_EMULATION
