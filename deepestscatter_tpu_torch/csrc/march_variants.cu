// Alternatives of the package's march and descriptor kernels, for
// probes/march_variants.py: K4's item queue at other lookaheads, K4 as one
// thread per pixel over its samples (the mapping it replaced), K3's row
// kernel at other numbers of voxels a thread; K1 as one thread per ray (its
// first design) and with other numbers of lanes a ray; K2 as one thread per
// element (its first design) and with the light frame staged in shared
// memory; K7a as a warp a sample walking its attempts in order (its first
// design) and with K1's 8 lanes a sample, and with other numbers of warps a
// sample; K7b as K4's item queue with a per-lane base (its first design),
// and with its scatters deferred at other numbers of parked lanes and other
// lookaheads; K7a's cell jump (ds_samples_skip with kSkipCell) as its first
// design (the package's rounds of 8 warps, each attempt in chunks of 32
// lanes ended after the first lane in an empty cell;
// ds_cell_samples_variant).  Every alternative computes the
// same values as the kernels the package runs.
//
// The package's entry points are renamed where they are included; the
// ds_pathtrace, ds_bake, ds_march, ds_descriptor, ds_samples and ds_radiance here
// take the same arguments and run the alternative ds_variant /
// ds_neural_variant / ds_samples_variant / ds_radiance_variant chose, so the
// wrappers' _launch(lib=) drives them.
#define ds_pathtrace ds_pathtrace_package
#define ds_bake ds_bake_package
#define ds_march ds_march_package
#define ds_descriptor ds_descriptor_package
#define ds_samples ds_samples_package
#define ds_samples_skip ds_samples_skip_package
#define ds_radiance ds_radiance_package
#include "pathtrace.cu"
#include "inscatter.cu"
#include "march.cu"
#include "descriptor.cu"
#include "samples.cu"
#undef ds_pathtrace
#undef ds_bake
#undef ds_march
#undef ds_descriptor
#undef ds_samples
#undef ds_samples_skip
#undef ds_radiance

namespace {

int g_pixel = 0;  // K4: 0 the item queue, 1 one thread per pixel
// K4's lookahead; with one thread per pixel, 0 marches with trace_sample
// (int64 tap offsets and IEEE divisions, as before the queue).
int g_lookahead = ds::kLookahead;
int g_voxels = ds::kBakeVoxels;  // K3's voxels a thread
int g_lanes = ds::kMarchLanes;  // K1's lanes a ray; 0: one thread per ray
int g_desc = 1;  // K2: 0 a thread per element, 1 the package's, 2 staged frames
int g_sample_warps = ds::kSampleWarps;  // K7a's warps a sample; 0: a group of lanes a sample
int g_sample_lanes = 32;  // K7a's lanes a sample where g_sample_warps is 0
// K7b: 0 K4's item queue (its first design), 1 deferred scatters; the
// parked lanes that resolve; lookahead.
int g_radiance = 1;
int g_park_at = ds::kParkAt;
int g_radiance_lookahead = ds::kLookahead;

constexpr int kSampleThreads = 128;

// K7a's first design: samples x G threads, group g of G lanes taking
// sample blockIdx * (threads / G) + g through its attempts in order.
template <int G, typename T>
__global__ void __launch_bounds__(kSampleThreads) samples_kernel(
    const T* __restrict__ dens, int nx, int ny, int nz, uint32_t seed, int64_t n,
    ds::MarchConsts c, float min_dist, float* __restrict__ pos_out,
    float* __restrict__ dir_out, uint8_t* __restrict__ found_out,
    int32_t* __restrict__ work_out) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G: a power of two up to 32");
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int shift = lane - gl;
  const unsigned gmask = ds::lanes_below(G) << shift;
  const int64_t s = ((int64_t)blockIdx.x * kSampleThreads + threadIdx.x) / G;
  if (s >= n) return;  // whole groups: n x G threads, G divides the block
  ds::Ray R;
  bool found = false;
  int k = 0, steps = 0;
  while (!found && k < ds::kMaxAttempts) {  // uniform over the group
    ds::attempt_start(R, ds::attempt_ray(seed, (uint32_t)s, k, c, min_dist), c);
    ++k;
    attempt_march_lanes<G>(R, gl, gmask, shift, dens, nx, ny, nz, c);
    steps += R.steps;
    found = ds::accepted(R, c);
  }
  if (gl == 0) ds::sample_end(s, found, R, c, k, steps, pos_out, dir_out, found_out, work_out);
}

template <int G>
static int samples_lanes(const void* dens, int is_u8, int nx, int ny, int nz, uint32_t seed,
                         int64_t n, const ds::MarchConsts& c, float min_dist, float* pos_out,
                         float* dir_out, uint8_t* found_out, int32_t* work_out,
                         cudaStream_t s) {
  const unsigned blocks = (unsigned)((n * G + kSampleThreads - 1) / kSampleThreads);
  if (is_u8) {
    samples_kernel<G, uint8_t><<<blocks, kSampleThreads, 0, s>>>(
        (const uint8_t*)dens, nx, ny, nz, seed, n, c, min_dist, pos_out, dir_out, found_out,
        work_out);
  } else {
    samples_kernel<G, float><<<blocks, kSampleThreads, 0, s>>>(
        (const float*)dens, nx, ny, nz, seed, n, c, min_dist, pos_out, dir_out, found_out,
        work_out);
  }
  return (int)cudaGetLastError();
}

// K7a's cell jump (ds_cell_samples_variant): 0 the first design, 1 the
// package's (a thread an attempt).
int g_cell_samples = 1;

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

// K1's first design: one thread per ray over march_ray (int64 taps, IEEE
// divisions by bbox in the step loop).
template <typename T>
__global__ void __launch_bounds__(kMarchThreads) march_ray_kernel(
    const T* __restrict__ dens, const T* __restrict__ insc, int nx, int ny, int nz,
    const float* __restrict__ eval_rows, const float* __restrict__ entry,
    const float* __restrict__ dirs, const int64_t* __restrict__ ray_ids,
    const float* __restrict__ trans_total, uint32_t seed, int64_t n, ds::MarchConsts c,
    float* __restrict__ t_out, float* __restrict__ pos_out,
    uint8_t* __restrict__ ok_out, float* __restrict__ direct_out) {
  const int64_t r = (int64_t)blockIdx.x * kMarchThreads + threadIdx.x;
  if (r >= n) return;
  ds::march_ray(r, dens, insc, nx, ny, nz, eval_rows, entry, dirs, ray_ids, trans_total,
                seed, c, t_out, pos_out, ok_out, direct_out);
}

// K2's first design: one thread per output element.
template <typename T>
__global__ void __launch_bounds__(kDescThreads) descriptor_element_kernel(
    const T* __restrict__ mips, const float* __restrict__ pos,
    const float* __restrict__ dirs, const float* __restrict__ frames,
    const float* __restrict__ ez, const float* __restrict__ light, int64_t total,
    ds::DescConsts c, float* __restrict__ out) {
  const int64_t gid = (int64_t)blockIdx.x * kDescThreads + threadIdx.x;
  if (gid >= total) return;
  out[gid] = ds::descriptor_element(gid, mips, pos, dirs, frames, ez, light, c);
}

// The package's K2 with the light frames of the block's points (at most
// three: 256 threads over rows of 226) computed once and staged in shared
// memory.
template <typename T>
__global__ void __launch_bounds__(kDescThreads) descriptor_staged_kernel(
    const T* __restrict__ mips, const float* __restrict__ pos,
    const float* __restrict__ dirs, const float* __restrict__ frames,
    const float* __restrict__ ez, const float* __restrict__ light, int total,
    ds::DescConsts c, float* __restrict__ out) {
  static_assert(kDescThreads <= 2 * ds::kRowWidth + 1, "a block spans at most 3 points");
  __shared__ ds::PointFrame staged[3];
  const int base = blockIdx.x * kDescThreads;
  const int first = base / ds::kRowWidth;
  const int end = base + kDescThreads < total ? base + kDescThreads : total;
  const int last = (end - 1) / ds::kRowWidth;
  const int t = threadIdx.x;
  if (t <= last - first) {
    const int p = first + t;
    staged[t] = ds::point_frame(ez, frames[3 * p], frames[3 * p + 1], frames[3 * p + 2]);
  }
  __syncthreads();
  const int gid = base + t;
  if (gid >= total) return;
  const int p = gid / ds::kRowWidth;
  const int col = gid - p * ds::kRowWidth;
  ds::descriptor_column(p, col, mips, pos, dirs, light, c, staged[p - first], out);
}

extern "C" {

// K1: lanes 0 (one thread per ray), 4, 8, 16 or 32; K2: design 0 (a thread per
// element), 1 (the package's) or 2 (staged frames).  Another choice makes
// the entry points return -1.
void ds_neural_variant(int lanes, int desc) {
  g_lanes = lanes;
  g_desc = desc;
}

int ds_march(const void* dens, const void* insc, int is_u8, int nx, int ny, int nz,
             const float* eval_rows, int n_phase, const float* entry, const float* dirs,
             const int64_t* ray_ids, const float* trans_total, uint32_t seed, int64_t n,
             const float* consts, int max_steps, float* t_out, float* pos_out,
             uint8_t* ok_out, float* direct_out, unsigned long long* counters,
             void* stream) {
#define DS_LANES(G)                                                                        \
  march_lanes<G>(dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase, entry, dirs, ray_ids,    \
                 trans_total, seed, n, consts, max_steps, t_out, pos_out, ok_out,            \
                 direct_out, counters, stream)
  switch (g_lanes) {
    case 4: return DS_LANES(4);
    case 8: return DS_LANES(8);
    case 16: return DS_LANES(16);
    case 32: return DS_LANES(32);
    case 0: break;
    default: return -1;
  }
#undef DS_LANES
  cudaStream_t s = (cudaStream_t)stream;
  int err = (int)cudaMemsetAsync(counters, 0, 2 * sizeof(unsigned long long), s);
  if (err != 0 || n <= 0) return err;
  const ds::MarchConsts c = ds::march_consts(consts, max_steps, n_phase);
  const unsigned blocks = (unsigned)((n + kMarchThreads - 1) / kMarchThreads);
  if (is_u8) {
    march_ray_kernel<uint8_t><<<blocks, kMarchThreads, 0, s>>>(
        (const uint8_t*)dens, (const uint8_t*)insc, nx, ny, nz, eval_rows, entry, dirs,
        ray_ids, trans_total, seed, n, c, t_out, pos_out, ok_out, direct_out);
  } else {
    march_ray_kernel<float><<<blocks, kMarchThreads, 0, s>>>(
        (const float*)dens, (const float*)insc, nx, ny, nz, eval_rows, entry, dirs,
        ray_ids, trans_total, seed, n, c, t_out, pos_out, ok_out, direct_out);
  }
  return (int)cudaGetLastError();
}

int ds_descriptor(const void* mips, int is_u8, const float* pos, const float* dirs,
                  const float* frames, const float* ez, const float* light, int64_t m,
                  int n_layers, int n_levels, const float* fconsts, const int64_t* iconsts,
                  float* out, void* stream) {
  if (g_desc == 1) {
    return ds_descriptor_package(mips, is_u8, pos, dirs, frames, ez, light, m, n_layers,
                                 n_levels, fconsts, iconsts, out, stream);
  }
  if (g_desc != 0 && g_desc != 2) return -1;
  if (!ds::desc_args_ok(m, n_layers, n_levels)) return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  const ds::DescConsts c = ds::desc_consts(fconsts, iconsts, n_layers, n_levels);
  cudaStream_t s = (cudaStream_t)stream;
  if (g_desc == 0) {
    const int64_t total = m * n_layers * ds::kRowWidth;
    const unsigned blocks = (unsigned)((total + kDescThreads - 1) / kDescThreads);
    if (is_u8) {
      descriptor_element_kernel<uint8_t><<<blocks, kDescThreads, 0, s>>>(
          (const uint8_t*)mips, pos, dirs, frames, ez, light, total, c, out);
    } else {
      descriptor_element_kernel<float><<<blocks, kDescThreads, 0, s>>>(
          (const float*)mips, pos, dirs, frames, ez, light, total, c, out);
    }
  } else {
    const int total = (int)(m * ds::kRowWidth);
    const unsigned blocks = (unsigned)((total + kDescThreads - 1) / kDescThreads);
    if (is_u8) {
      descriptor_staged_kernel<uint8_t><<<blocks, kDescThreads, 0, s>>>(
          (const uint8_t*)mips, pos, dirs, frames, ez, light, total, c, out);
    } else {
      descriptor_staged_kernel<float><<<blocks, kDescThreads, 0, s>>>(
          (const float*)mips, pos, dirs, frames, ez, light, total, c, out);
    }
  }
  return (int)cudaGetLastError();
}

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

// K7a: warps > 0 runs rounds of 2, 4, 8 or 16 warps a sample (the package
// runs kSampleWarps); warps 0 a group of 8 or 32 lanes a sample walking its
// attempts in order (its first design ran 32).  Another choice makes
// ds_samples return -1.
void ds_samples_variant(int warps, int lanes) {
  g_sample_warps = warps;
  g_sample_lanes = lanes;
}

int ds_samples(const void* dens, int is_u8, int nx, int ny, int nz, uint32_t seed, int64_t n,
               const float* consts, int max_steps, float min_dist, float* pos_out,
               float* dir_out, uint8_t* found_out, int32_t* work_out, void* stream) {
  if (n <= 0) return 0;
  const ds::MarchConsts c = ds::march_consts(consts, max_steps, 0);
  cudaStream_t s = (cudaStream_t)stream;
#define DS_ROUNDS(W) \
  samples_rounds<W>(dens, is_u8, nx, ny, nz, seed, n, c, min_dist, pos_out, dir_out, found_out, \
                    work_out, s)
#define DS_LANES(G) \
  samples_lanes<G>(dens, is_u8, nx, ny, nz, seed, n, c, min_dist, pos_out, dir_out, found_out, \
                   work_out, s)
  switch (g_sample_warps) {
    case 2: return DS_ROUNDS(2);
    case 4: return DS_ROUNDS(4);
    case 8: return DS_ROUNDS(8);
    case 16: return DS_ROUNDS(16);
    case 0: break;
    default: return -1;
  }
  switch (g_sample_lanes) {
    case 8: return DS_LANES(8);
    case 32: return DS_LANES(32);
  }
  return -1;
#undef DS_ROUNDS
#undef DS_LANES
}

// K7a's cell jump that ds_samples_skip runs (g_cell_samples' designs).
void ds_cell_samples_variant(int design) { g_cell_samples = design; }

int ds_samples_skip(const void* dens, int is_u8, int nx, int ny, int nz, uint32_t seed,
                    int64_t n, const float* consts, int max_steps, float min_dist,
                    float* pos_out, float* dir_out, uint8_t* found_out, int32_t* work_out,
                    void* stream, DS_SKIP_PARAMS) {
  if (skip != ds::kSkipCell || g_cell_samples != 0) {
    return ds_samples_skip_package(dens, is_u8, nx, ny, nz, seed, n, consts, max_steps,
                                   min_dist, pos_out, dir_out, found_out, work_out, stream, skip,
                                   occ, occ_x, occ_y, occ_z, block, long_steps, jumped, occ_bits,
                                   sure_steps);
  }
  if (n <= 0) return 0;
  const ds::MarchConsts c = ds::march_consts(consts, max_steps, 0);
  return samples_rounds<ds::kSampleWarps, ds::kSkipCell>(dens, is_u8, nx, ny, nz, seed, n, c,
                                                         min_dist, pos_out, dir_out, found_out,
                                                         work_out, (cudaStream_t)stream,
                                                         DS_SKIP_ARGS);
}

// K7b: design 0 K4's item queue with the per-lane base (its first design,
// lookahead kLookahead), 1 deferred scatters at park_at 1 .. 32 and
// lookahead 1, 2 or 4.  Another choice makes ds_radiance return -1.
void ds_radiance_variant(int design, int park_at, int lookahead) {
  g_radiance = design;
  g_park_at = park_at;
  g_radiance_lookahead = lookahead;
}

int ds_radiance(const void* dens, const void* insc, int is_u8, int nx, int ny, int nz,
                const float* eval_rows, int n_phase, const float* inv_rows, int n_inv,
                const float* entry, const float* dirs, const uint8_t* hit,
                const int64_t* ray_ids, int64_t n, const float* consts, const float* ground,
                int max_steps, int max_depth, int rr_start, int flags, uint32_t seed_base,
                const uint32_t* sub0, int n_samples, float* rec_rad, int32_t* rec_work,
                unsigned long long* counters, float* mean_out, float* m2_out,
                float* count_out, int64_t* work_out, void* stream) {
#define DS_DEFERRED(K)                                                                       \
  radiance_queue<K>(dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase, inv_rows, n_inv,       \
                    entry, dirs, hit, ray_ids, n, consts, ground, max_steps, max_depth,       \
                    rr_start, flags, seed_base, sub0, n_samples, g_park_at, rec_rad,          \
                    rec_work, counters, mean_out, m2_out, count_out, work_out, stream)
  if (g_radiance == 0) {
    if (sub0 == nullptr) return (int)cudaErrorInvalidValue;
    return pathtrace_queue<ds::kLookahead>(
        dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase, inv_rows, n_inv, entry, dirs, hit,
        ray_ids, n, consts, ground, max_steps, max_depth, rr_start, flags, seed_base, 0u,
        n_samples, rec_rad, rec_work, counters, mean_out, m2_out, count_out, work_out, stream,
        sub0);
  }
  if (g_radiance != 1) return -1;
  switch (g_radiance_lookahead) {
    case 1: return DS_DEFERRED(1);
    case 2: return DS_DEFERRED(2);
    case 4: return DS_DEFERRED(4);
  }
  return -1;
#undef DS_DEFERRED
}

}  // extern "C"
