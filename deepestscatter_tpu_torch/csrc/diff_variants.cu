// Alternatives of the differentiable renderer's two adjoint kernels, for
// probes/march_variants.py and chip_smoke.py's diff phase: K8a as a thread
// a voxel (the first design, bake_adjoint_voxel) and as rows of V voxels a
// thread for each V; K8b's adjoint as a thread a ray (the first design,
// march_ray_adjoint) and with G lanes a ray for each G, each also with its
// grid scatters aimed at a scratch slot of its own a thread (the atomics
// issued, no texel shared) or left out (the values computed, nothing
// added): the split of its time between the atomics and the arithmetic.
// Every alternative with its scatters in place computes what the package's
// kernels compute (K8a within float64 rounding, K8b's adjoint within the
// float32 rounding of its atomics' order).
//
// A source of its own rather than a part of csrc/march_variants.cu: it
// includes only csrc/diff.cu, so chip_smoke.py builds it beside the
// package's sources in seconds.  The package's entry points are renamed
// where they are included; the ds_bake_adjoint(_blocks) and
// ds_diff_march_bwd here take the same arguments and run the alternative
// ds_diff_variant chose, so the wrappers' lib= argument drives them.
#define ds_bake_adjoint ds_bake_adjoint_package
#define ds_bake_adjoint_blocks ds_bake_adjoint_blocks_package
#define ds_diff_march_bwd ds_diff_march_bwd_package
#include "diff.cu"
#undef ds_bake_adjoint
#undef ds_bake_adjoint_blocks
#undef ds_diff_march_bwd

namespace {

int g_k8a = ds::diff::kAdjVoxels;  // K8a: 0 a thread a voxel; V rows of V voxels a thread
int g_k8b = ds::diff::kDiffLanes;  // K8b's adjoint: 0 a thread a ray; G lanes a ray
int g_scatter = 0;  // 0 atomics into the grids; 1 a scratch slot a thread; 2 none

constexpr int kScratch = 1 << 16;
__device__ float g_scratch[kScratch];
__device__ double g_scratch64[kScratch];

// The adjoint's grid scatters for g_scatter = A.
template <int A>
struct Scatter {
  template <typename G>
  __device__ __forceinline__ void operator()(G* p, float v) const {
    if (v == 0.0f) return;
    if (A == 0) {
      atomicAdd(p, (G)v);
    } else if (A == 1) {
      const unsigned slot = (blockIdx.x * blockDim.x + threadIdx.x) & (kScratch - 1);
      if (sizeof(G) == 8) {
        atomicAdd(g_scratch64 + slot, (double)v);
      } else {
        atomicAdd(g_scratch + slot, v);
      }
    } else if (v != v) {  // never for a finite v: keeps v computed
      g_scratch[0] = v;
    }
  }
};

}  // namespace

// K8a's first design: a thread a voxel, partial rows of kDiffThreads voxels.
template <int A>
__global__ void __launch_bounds__(kDiffThreads) bake_adjoint_voxel_kernel(
    const float* __restrict__ dens, ds::diff::AdjConsts c, int n_steps,
    const float* __restrict__ trans, const float* __restrict__ gbar, double* d_dens,
    double* partials, int64_t n) {
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  float dl[3] = {0.0f, 0.0f, 0.0f}, out[3];
  if (v < n) {
    ds::diff::bake_adjoint_voxel(v, dens, c, n_steps, trans[v], gbar[v], d_dens, dl,
                                 Scatter<A>());
  }
  block_sum3(dl, out);
  if (threadIdx.x == 0) {
    for (int a = 0; a < 3; ++a) partials[3 * (int64_t)blockIdx.x + a] = out[a];
  }
}

// K8b's adjoint's first design: a thread a ray.
template <int A>
__global__ void __launch_bounds__(kDiffThreads) march_bwd_ray_kernel(
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
                                         d_baked, de, dd, dts, Scatter<A>());
  }
  for (int a = 0; a < 3; ++a) {
    d_entry[3 * r + a] = de[a];
    d_dirs[3 * r + a] = dd[a];
    if (d_ts != nullptr) d_ts[3 * r + a] = dts[a];
  }
  d_phase[r] = dphase;
}

template <int G, int A>
__global__ void __launch_bounds__(kDiffThreads) march_bwd_lanes_variant_kernel(
    const float* __restrict__ dens, const float* __restrict__ baked,
    const float* __restrict__ to_sun, ds::diff::MarchConsts c, const float* __restrict__ entry,
    const float* __restrict__ dirs, const float* __restrict__ phase,
    const uint8_t* __restrict__ hit, const float* __restrict__ rad,
    const float* __restrict__ g_rad, int64_t n, float* d_dens, float* d_baked, float* d_entry,
    float* d_dirs, float* d_phase, float* d_ts) {
  march_bwd_lanes<G>(dens, baked, to_sun, c, entry, dirs, phase, hit, rad, g_rad, n, d_dens,
                     d_baked, d_entry, d_dirs, d_phase, d_ts, Scatter<A>());
}

extern "C" {

// K8a: 0 a thread a voxel; 1, 2 or 4 the row kernel with that many voxels
// a thread (the package's form).  K8b's adjoint: 0 a thread a ray, or G = 4, 8, 16 or 32 lanes a
// ray.  The scatters of K8a's first design and of K8b's adjoint: 0 atomics into
// the grids, 1 a scratch slot a thread, 2 none (results then meaningless;
// the row kernels take 0 only).  Another choice makes the entry points
// return -1.
void ds_diff_variant(int k8a, int k8b, int scatter) {
  g_k8a = k8a;
  g_k8b = k8b;
  g_scatter = scatter;
}

int64_t ds_bake_adjoint_blocks(int nx, int ny, int nz) {
  if (g_k8a == 0) return ((int64_t)nx * ny * nz + kDiffThreads - 1) / kDiffThreads;
  return ds::diff::row_launch(nx, ny, nz, g_k8a).partials;
}

int ds_bake_adjoint(const float* dens, int nx, int ny, int nz, const float* consts,
                    int n_steps, const float* trans, const float* gbar, double* d_dens,
                    double* partials, void* stream) {
#define DS_ROWS(V) \
  bake_adjoint_rows<V>(dens, nx, ny, nz, consts, n_steps, trans, gbar, d_dens, partials, stream)
  if (g_k8a != 0 && g_scatter != 0) return -1;
  switch (g_k8a) {
    case 1: return DS_ROWS(1);
    case 2: return DS_ROWS(2);
    case 4: return DS_ROWS(4);
    case 0: break;
    default: return -1;
  }
#undef DS_ROWS
  const int64_t n = (int64_t)nx * ny * nz;
  if (n <= 0) return 0;
  const ds::diff::AdjConsts c = ds::diff::adj_consts(nx, ny, nz, consts);
  cudaStream_t s = (cudaStream_t)stream;
  switch (g_scatter) {
    case 0:
      bake_adjoint_voxel_kernel<0><<<blocks_for(n), kDiffThreads, 0, s>>>(
          dens, c, n_steps, trans, gbar, d_dens, partials, n);
      break;
    case 1:
      bake_adjoint_voxel_kernel<1><<<blocks_for(n), kDiffThreads, 0, s>>>(
          dens, c, n_steps, trans, gbar, d_dens, partials, n);
      break;
    case 2:
      bake_adjoint_voxel_kernel<2><<<blocks_for(n), kDiffThreads, 0, s>>>(
          dens, c, n_steps, trans, gbar, d_dens, partials, n);
      break;
    default:
      return -1;
  }
  return (int)cudaGetLastError();
}

int ds_diff_march_bwd(const float* dens, const float* baked, const float* to_sun, int nx,
                      int ny, int nz, const float* consts, int n_steps, int sun_steps,
                      const float* entry, const float* dirs, const float* phase,
                      const uint8_t* hit, const float* rad, const float* g_rad, int64_t n,
                      float* d_dens, float* d_baked, float* d_entry, float* d_dirs,
                      float* d_phase, float* d_ts, void* stream) {
  if (n <= 0) return 0;
  if (g_scatter < 0 || g_scatter > 2) return -1;
  const ds::diff::MarchConsts c =
      ds::diff::march_consts(nx, ny, nz, consts, n_steps, sun_steps, baked != nullptr);
  cudaStream_t s = (cudaStream_t)stream;
#define DS_ARGS                                                                              \
  dens, baked, to_sun, c, entry, dirs, phase, hit, rad, g_rad, n, d_dens, d_baked, d_entry, \
      d_dirs, d_phase, d_ts
#define DS_RAY(A) march_bwd_ray_kernel<A><<<blocks_for(n), kDiffThreads, 0, s>>>(DS_ARGS)
#define DS_LANES(G, A)                                                                \
  march_bwd_lanes_variant_kernel<G, A>                                                \
      <<<(unsigned)((n * G + kDiffThreads - 1) / kDiffThreads), kDiffThreads, 0, s>>>( \
          DS_ARGS)
#define DS_SCATTER(LAUNCH) \
  switch (g_scatter) {     \
    case 0: LAUNCH(0); break; \
    case 1: LAUNCH(1); break; \
    default: LAUNCH(2); break; \
  }
#define DS_L4(A) DS_LANES(4, A)
#define DS_L8(A) DS_LANES(8, A)
#define DS_L16(A) DS_LANES(16, A)
#define DS_L32(A) DS_LANES(32, A)
  switch (g_k8b) {
    case 0: DS_SCATTER(DS_RAY) break;
    case 4: DS_SCATTER(DS_L4) break;
    case 8: DS_SCATTER(DS_L8) break;
    case 16: DS_SCATTER(DS_L16) break;
    case 32: DS_SCATTER(DS_L32) break;
    default: return -1;
  }
#undef DS_L4
#undef DS_L8
#undef DS_L16
#undef DS_L32
#undef DS_SCATTER
#undef DS_LANES
#undef DS_RAY
#undef DS_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"
