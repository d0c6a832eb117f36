// K1: the neural camera march, one thread per ray.
//
// Replaces the XLA loop of deepestscatter_tpu/ops/march.py::
// next_scattering_event (lines 100-286) as render/neural.py::march_pass1 and
// march_pass2 call it (march_pipeline=True, stop_at_scatter=False, the
// cloud-AABB clip), with render/pathtracer.py::in_scattering(chopped=False)
// fused into the pass-2 epilogue.
//
// Per ray: jump to the cloud AABB on the step lattice (enter_k =
// floor(t_near / step), one jump pos + dir * (enter_k * step)); then step,
// sample, attenuate: cur += dir * step, sigma = trilinear(density) * dm,
// T *= exp(-sigma * step); the first step with od > T is the scatter,
// pulled back by log(od / T) / sigma; the loop ends when cur leaves the
// AABB.  Pass 1 uses od = 0 (never scatters) and gives the total T.  Pass 2
// uses od = 1 - u (1 - T_total), u = hash_uniform(seed, ray_id, 0); rays
// that do not scatter report the analytic box exit; ok = scattered &&
// in_box(pos); NEE = radiance * phase(cos to sun) * T_sun(pos) * ratio.
//
// The step cap is max_march_steps steps.  The JAX loop caps iterations of
// up to march_substeps steps each, but a ray that starts inside the box
// needs at most ceil(sqrt(3)/step) + 2 steps, fewer than the cap, so
// neither cap binds and the values are the same.
//
// Bound on the card: the density texture (16.7 MB at 256^3 uint8) stays
// in the 50 MB L2, so the loop is a chain of dependent L2 gathers plus
// ~70 float operations per step; the operation count is the roofline bound
// and gather latency the practical one.  Design of this first version: one
// thread per ray (no lockstep), so a ray that leaves the AABB frees its
// lane at once; rays are compacted to box hits (pass 1) and T < 1 (pass 2)
// by the caller.
#include "common.cuh"

namespace ds {

struct MarchConsts {
  float bbox[3];
  float lo[3];  // cloud AABB
  float hi[3];
  float step;
  float dm;  // density multiplier
  float light[3];  // light_dir (points from the sun)
  float radiance[3];
  float sun_ratio;
  int max_steps;
  int n_phase;
};

__device__ __forceinline__ bool in_box(float x, float y, float z, const float* b) {
  return x >= -0.01f && x <= b[0] + 0.01f && y >= -0.01f && y <= b[1] + 0.01f &&
         z >= -0.01f && z <= b[2] + 0.01f;
}

__device__ __forceinline__ float safe_dir(float d) {
  return fabsf(d) > 1e-9f ? d : 1e-9f;
}

template <typename T>
__device__ __forceinline__ void march_ray(
    int64_t r, const T* __restrict__ dens, const T* __restrict__ insc, int nx, int ny,
    int nz, const float* __restrict__ eval_rows, const float* __restrict__ entry,
    const float* __restrict__ dirs, const int64_t* __restrict__ ray_ids,
    const float* __restrict__ trans_total, uint32_t seed, const MarchConsts& c,
    float* __restrict__ t_out, float* __restrict__ pos_out,
    uint8_t* __restrict__ ok_out, float* __restrict__ direct_out) {
  const float px = entry[3 * r], py = entry[3 * r + 1], pz = entry[3 * r + 2];
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];

  float od = 0.0f;
  if (trans_total != nullptr) {
    const float u = hash_uniform(seed, (uint32_t)ray_ids[r], 0u);
    od = 1.0f - u * (1.0f - trans_total[r]);
  }

  // Clip to the cloud AABB on the step lattice.
  const float sx = safe_dir(dx), sy = safe_dir(dy), sz = safe_dir(dz);
  const float tax = (c.lo[0] - px) / sx, tbx = (c.hi[0] - px) / sx;
  const float tay = (c.lo[1] - py) / sy, tby = (c.hi[1] - py) / sy;
  const float taz = (c.lo[2] - pz) / sz, tbz = (c.hi[2] - pz) / sz;
  const float t_near = fmaxf(
      fmaxf(fmaxf(fminf(tax, tbx), fminf(tay, tby)), fminf(taz, tbz)), 0.0f);
  const float t_far = fminf(fminf(fmaxf(tax, tbx), fmaxf(tay, tby)), fmaxf(taz, tbz));
  const bool hits = t_far > t_near;
  const float jump = (hits ? floorf(t_near / c.step) : 0.0f) * c.step;
  float cx = px + dx * jump, cy = py + dy * jump, cz = pz + dz * jump;

  bool active = in_box(px, py, pz, c.bbox) && hits;
  float trans = 1.0f;
  bool scattered = false;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;  // scatter position
  for (int s = 0; active && s < c.max_steps; ++s) {
    const float ax = cx + dx * c.step, ay = cy + dy * c.step, az = cz + dz * c.step;
    const float density =
        trilinear(dens, nx, ny, nz, ax / c.bbox[0], ay / c.bbox[1], az / c.bbox[2]) *
        c.dm;
    const float tn = trans * expf(-density * c.step);
    if (!scattered && od > tn) {
      const float back =
          logf(fmaxf(od, 1e-20f) / fmaxf(tn, 1e-20f)) / fmaxf(density, 1e-10f);
      qx = ax - dx * back;
      qy = ay - dy * back;
      qz = az - dz * back;
      scattered = true;
    }
    trans = tn;
    cx = ax;
    cy = ay;
    cz = az;
    active = cx >= c.lo[0] && cx <= c.hi[0] && cy >= c.lo[1] && cy <= c.hi[1] &&
             cz >= c.lo[2] && cz <= c.hi[2];
  }
  t_out[r] = trans;
  if (pos_out == nullptr) return;  // pass 1: total transmittance only

  if (!scattered) {  // analytic full-box exit
    const float fx = fmaxf((0.0f - px) / sx, (c.bbox[0] - px) / sx);
    const float fy = fmaxf((0.0f - py) / sy, (c.bbox[1] - py) / sy);
    const float fz = fmaxf((0.0f - pz) / sz, (c.bbox[2] - pz) / sz);
    const float t_exit = fminf(fminf(fx, fy), fz);
    qx = px + dx * t_exit;
    qy = py + dy * t_exit;
    qz = pz + dz * t_exit;
  }
  const bool ok = scattered && in_box(qx, qy, qz, c.bbox);
  float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
  if (ok) {
    const float cosl = ((-c.light[0]) * dx + (-c.light[1]) * dy) + (-c.light[2]) * dz;
    const float t = ((cosl + 1.0f) * 0.5f) * (float)c.n_phase - 0.5f;
    const float t0 = floorf(t);
    const float frac = t0 < 0.0f ? 0.0f : t - t0;
    int i0 = (int)fminf(fmaxf(t0, -1.0f), (float)c.n_phase);
    i0 = i0 < 0 ? 0 : (i0 > c.n_phase - 1 ? c.n_phase - 1 : i0);
    const float mie = eval_rows[4 * i0] * (1.0f - frac) + eval_rows[4 * i0 + 1] * frac;
    const float sun_t =
        trilinear(insc, nx, ny, nz, qx / c.bbox[0], qy / c.bbox[1], qz / c.bbox[2]);
    const float scale = mie * sun_t * c.sun_ratio;
    d0 = c.radiance[0] * scale;
    d1 = c.radiance[1] * scale;
    d2 = c.radiance[2] * scale;
  }
  pos_out[3 * r] = qx;
  pos_out[3 * r + 1] = qy;
  pos_out[3 * r + 2] = qz;
  ok_out[r] = ok ? 1 : 0;
  direct_out[3 * r] = d0;
  direct_out[3 * r + 1] = d1;
  direct_out[3 * r + 2] = d2;
}

inline MarchConsts march_consts(const float* k, int max_steps, int n_phase) {
  MarchConsts c;
  for (int i = 0; i < 3; ++i) {
    c.bbox[i] = k[i];
    c.lo[i] = k[3 + i];
    c.hi[i] = k[6 + i];
    c.light[i] = k[11 + i];
    c.radiance[i] = k[14 + i];
  }
  c.step = k[9];
  c.dm = k[10];
  c.sun_ratio = k[17];
  c.max_steps = max_steps;
  c.n_phase = n_phase;
  return c;
}

}  // namespace ds

#ifndef DS_HOST_EMULATION

template <typename T>
__global__ void __launch_bounds__(128) march_kernel(
    const T* __restrict__ dens, const T* __restrict__ insc, int nx, int ny, int nz,
    const float* __restrict__ eval_rows, const float* __restrict__ entry,
    const float* __restrict__ dirs, const int64_t* __restrict__ ray_ids,
    const float* __restrict__ trans_total, uint32_t seed, int64_t n,
    ds::MarchConsts c, float* __restrict__ t_out, float* __restrict__ pos_out,
    uint8_t* __restrict__ ok_out, float* __restrict__ direct_out) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  ds::march_ray(r, dens, insc, nx, ny, nz, eval_rows, entry, dirs, ray_ids,
                trans_total, seed, c, t_out, pos_out, ok_out, direct_out);
}

// consts: bbox[3], aabb_lo[3], aabb_hi[3], step, dm, light_dir[3],
// light_radiance[3], sun_solid_angle_ratio (18 host floats).  trans_total
// null selects pass 1; then pos_out, ok_out and direct_out may be null.
// Returns cudaGetLastError() after the launch.
extern "C" int ds_march(const void* dens, const void* insc, int is_u8, int nx, int ny,
                        int nz, const float* eval_rows, int n_phase, const float* entry,
                        const float* dirs, const int64_t* ray_ids,
                        const float* trans_total, uint32_t seed, int64_t n,
                        const float* consts, int max_steps, float* t_out,
                        float* pos_out, uint8_t* ok_out, float* direct_out,
                        void* stream) {
  if (n <= 0) return 0;
  const ds::MarchConsts c = ds::march_consts(consts, max_steps, n_phase);
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_u8) {
    march_kernel<uint8_t><<<blocks, threads, 0, s>>>(
        (const uint8_t*)dens, (const uint8_t*)insc, nx, ny, nz, eval_rows, entry, dirs,
        ray_ids, trans_total, seed, n, c, t_out, pos_out, ok_out, direct_out);
  } else {
    march_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)dens, (const float*)insc, nx, ny, nz, eval_rows, entry, dirs,
        ray_ids, trans_total, seed, n, c, t_out, pos_out, ok_out, direct_out);
  }
  return (int)cudaGetLastError();
}

#endif  // DS_HOST_EMULATION
