// Alternatives of the two march kernels, for probes/march_variants.py:
// K4's item queue at other lookaheads, K4 as one thread per pixel over its
// samples (the mapping it replaced), and K3's row kernel at other numbers
// of voxels a thread.  Every alternative computes the same values as the
// kernels the package runs.
//
// The package's entry points are renamed where they are included; the
// ds_pathtrace and ds_bake here take the same arguments and run the
// alternative ds_variant chose, so the wrappers' _launch(lib=) drives them.
#define ds_pathtrace ds_pathtrace_package
#define ds_bake ds_bake_package
#include "pathtrace.cu"
#include "inscatter.cu"
#undef ds_pathtrace
#undef ds_bake

namespace {

int g_pixel = 0;  // K4: 0 the item queue, 1 one thread per pixel
// K4's lookahead; with one thread per pixel, 0 marches with trace_sample
// (int64 tap offsets and IEEE divisions, as before the queue).
int g_lookahead = ds::kLookahead;
int g_voxels = ds::kBakeVoxels;  // K3's voxels a thread

}  // namespace

// One thread per pixel over its samples: pathtrace_pixel, whose march is
// trace_sample, for K = 0; the same loop with march_chunk<K> for K >= 1.
template <int K, typename T>
__global__ void __launch_bounds__(kPtThreads) pixel_kernel(
    const T* __restrict__ dens, const T* __restrict__ insc, int nx, int ny, int nz,
    const float* __restrict__ eval_rows, const float* __restrict__ inv,
    const float* __restrict__ entry, const float* __restrict__ dirs,
    const uint8_t* __restrict__ hit, const int64_t* __restrict__ ray_ids, int64_t n,
    ds::PtConsts c, uint32_t seed_base, uint32_t sub_first, int n_samples,
    float* __restrict__ mean_out, float* __restrict__ m2_out,
    float* __restrict__ count_out, int64_t* __restrict__ work_out) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  if constexpr (K == 0) {
    ds::pathtrace_pixel(r, dens, insc, nx, ny, nz, eval_rows, inv, entry, dirs, hit,
                        ray_ids, c, seed_base, sub_first, n_samples, mean_out, m2_out,
                        count_out, work_out);
  } else {
    float mean[3] = {0.0f, 0.0f, 0.0f}, m2[3] = {0.0f, 0.0f, 0.0f};
    float cnt = 0.0f;
    int64_t steps = 0, bounces = 0;
    if (hit[r]) {
      const float ex = entry[3 * r], ey = entry[3 * r + 1], ez = entry[3 * r + 2];
      const bool entry_in = ds::in_box(ex, ey, ez, c.bbox);
      for (int k = 0; k < n_samples; ++k) {
        const uint32_t seed = seed_base ^ ((sub_first + (uint32_t)k) * 0x9E3779B1u);
        float rad[3] = {0.0f, 0.0f, 0.0f};
        if (entry_in) {
          ds::Sample S;
          ds::begin_sample(S, c, inv, seed, (uint32_t)ray_ids[r], ex, ey, ez, dirs[3 * r],
                           dirs[3 * r + 1], dirs[3 * r + 2]);
          while (!ds::march_chunk<K>(S, dens, insc, nx, ny, nz, eval_rows, inv, c)) {
          }
          for (int i = 0; i < 3; ++i) rad[i] = S.rad[i];
          steps += S.steps;
          bounces += S.bounces;
        }
        ds::welford_add(mean, m2, cnt, rad);
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
}

template <int K>
static int pathtrace_pixels(const void* dens, const void* insc, int is_u8, int nx, int ny,
                            int nz, const float* eval_rows, int n_phase,
                            const float* inv_rows, int n_inv, const float* entry,
                            const float* dirs, const uint8_t* hit, const int64_t* ray_ids,
                            int64_t n, const float* consts, const float* ground,
                            int max_steps, int max_depth, int rr_start, int flags,
                            uint32_t seed_base, uint32_t sub_first, int n_samples,
                            float* mean_out, float* m2_out, float* count_out,
                            int64_t* work_out, void* stream) {
  if (n <= 0) return 0;
  const ds::PtConsts c =
      ds::pt_consts(consts, ground, max_steps, max_depth, rr_start, n_phase, n_inv, flags);
  const unsigned blocks = (unsigned)((n + kPtThreads - 1) / kPtThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_u8) {
    pixel_kernel<K, uint8_t><<<blocks, kPtThreads, 0, s>>>(
        (const uint8_t*)dens, (const uint8_t*)insc, nx, ny, nz, eval_rows, inv_rows, entry,
        dirs, hit, ray_ids, n, c, seed_base, sub_first, n_samples, mean_out, m2_out,
        count_out, work_out);
  } else {
    pixel_kernel<K, float><<<blocks, kPtThreads, 0, s>>>(
        (const float*)dens, (const float*)insc, nx, ny, nz, eval_rows, inv_rows, entry,
        dirs, hit, ray_ids, n, c, seed_base, sub_first, n_samples, mean_out, m2_out,
        count_out, work_out);
  }
  return (int)cudaGetLastError();
}

extern "C" {

// K4: pixel 0 (the queue) with lookahead 1, 2, 4 or 8, or pixel 1 with
// lookahead 0, 1 or 2; K3: voxels 1, 2, 4 or 8.  Another choice makes the
// entry points return -1.
void ds_variant(int pixel, int lookahead, int voxels) {
  g_pixel = pixel;
  g_lookahead = lookahead;
  g_voxels = voxels;
}

int ds_pathtrace(const void* dens, const void* insc, int is_u8, int nx, int ny, int nz,
                 const float* eval_rows, int n_phase, const float* inv_rows, int n_inv,
                 const float* entry, const float* dirs, const uint8_t* hit,
                 const int64_t* ray_ids, int64_t n, const float* consts, const float* ground,
                 int max_steps, int max_depth, int rr_start, int flags, uint32_t seed_base,
                 uint32_t sub_first, int n_samples, float* rec_rad, int32_t* rec_work,
                 unsigned long long* counters, float* mean_out, float* m2_out,
                 float* count_out, int64_t* work_out, void* stream) {
#define DS_PIXELS(K)                                                                         \
  pathtrace_pixels<K>(dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase, inv_rows, n_inv,    \
                      entry, dirs, hit, ray_ids, n, consts, ground, max_steps, max_depth,    \
                      rr_start, flags, seed_base, sub_first, n_samples, mean_out, m2_out,    \
                      count_out, work_out, stream)
#define DS_QUEUE(K)                                                                          \
  pathtrace_queue<K>(dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase, inv_rows, n_inv,     \
                     entry, dirs, hit, ray_ids, n, consts, ground, max_steps, max_depth,     \
                     rr_start, flags, seed_base, sub_first, n_samples, rec_rad, rec_work,    \
                     counters, mean_out, m2_out, count_out, work_out, stream)
  if (g_pixel) {
    switch (g_lookahead) {
      case 0: return DS_PIXELS(0);
      case 1: return DS_PIXELS(1);
      case 2: return DS_PIXELS(2);
    }
    return -1;
  }
  switch (g_lookahead) {
    case 1: return DS_QUEUE(1);
    case 2: return DS_QUEUE(2);
    case 4: return DS_QUEUE(4);
    case 8: return DS_QUEUE(8);
  }
  return -1;
#undef DS_PIXELS
#undef DS_QUEUE
}

int ds_bake(const void* dens, int is_u8, int nx, int ny, int nz, const float* consts,
            int n_steps, int early_out, float* out, void* stream) {
  switch (g_voxels) {
    case 1: return bake_rows<1>(dens, is_u8, nx, ny, nz, consts, n_steps, early_out, out, stream);
    case 2: return bake_rows<2>(dens, is_u8, nx, ny, nz, consts, n_steps, early_out, out, stream);
    case 4: return bake_rows<4>(dens, is_u8, nx, ny, nz, consts, n_steps, early_out, out, stream);
    case 8: return bake_rows<8>(dens, is_u8, nx, ny, nz, consts, n_steps, early_out, out, stream);
  }
  return -1;
}

}  // extern "C"
