// Alternatives of the differentiable renderer's kernels, for
// probes/march_variants.py and chip_smoke.py's diff phase: K8a as a thread
// a voxel (the first design, bake_adjoint_voxel) and as rows of V voxels a
// thread for each V; K8b's adjoint as a thread a ray (the first design,
// march_ray_adjoint) and with G lanes a ray for each G, each also with its
// grid scatters aimed at a scratch slot of its own a thread (the atomics
// issued, no texel shared) or left out (the values computed, nothing
// added): the split of its time between the atomics and the arithmetic.
// K8b's forward as a thread a ray (the first design, march_ray) and with G
// lanes a ray; the sun march and its adjoint as a thread a point (their
// first designs, sun_march and sun_march_adjoint) and with G lanes a point
// (sun_march_lanes, sun_march_adjoint_lanes: lane l on sun step c * G + l,
// the adjoint's scatters through group_deposit).  Every alternative with
// its scatters in place computes what the package's kernels compute (K8a
// within float64 rounding, the adjoints within the float32 rounding of
// their sums' and atomics' order; the forwards bitwise).
//
// A source of its own rather than a part of csrc/march_variants.cu: it
// includes only csrc/diff.cu, so chip_smoke.py builds it beside the
// package's sources in seconds.  The package's entry points are renamed
// where they are included; the ds_bake_adjoint(_blocks), ds_diff_march,
// ds_diff_march_bwd, ds_sun_march and ds_sun_march_bwd here take the same
// arguments and run the alternative ds_diff_variant and
// ds_diff_forward_variant chose, so the wrappers' lib= argument drives
// them.
#define ds_bake_adjoint ds_bake_adjoint_package
#define ds_bake_adjoint_blocks ds_bake_adjoint_blocks_package
#define ds_diff_march ds_diff_march_package
#define ds_diff_march_bwd ds_diff_march_bwd_package
#define ds_sun_march ds_sun_march_package
#define ds_sun_march_bwd ds_sun_march_bwd_package
#include "diff.cu"
#undef ds_bake_adjoint
#undef ds_bake_adjoint_blocks
#undef ds_diff_march
#undef ds_diff_march_bwd
#undef ds_sun_march
#undef ds_sun_march_bwd

namespace {

int g_k8a = ds::diff::kAdjVoxels;  // K8a: 0 a thread a voxel; V rows of V voxels a thread
int g_k8b = ds::diff::kDiffLanes;  // K8b's adjoint: 0 a thread a ray; G lanes a ray
int g_scatter = 0;  // 0 atomics into the grids; 1 a scratch slot a thread; 2 none
// K8b's forward: 0 a thread a ray; G lanes a ray.
int g_march = ds::diff::kDiffLanes;  // (the package's: ds_diff_forward_lanes)
// The sun march and its adjoint: 0 their first designs; 1 the package's
// thread a point; G > 1 lanes a point.
int g_sun = 1;
int g_sun_bwd = 1;

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

static unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kDiffThreads - 1) / kDiffThreads);
}

// K8b's forward's first design: a thread a ray.
__global__ void __launch_bounds__(kDiffThreads) march_ray_kernel(
    const float* __restrict__ dens, const float* __restrict__ baked,
    const float* __restrict__ to_sun, ds::diff::MarchConsts c, const float* __restrict__ entry,
    const float* __restrict__ dirs, const float* __restrict__ phase,
    const uint8_t* __restrict__ hit, int64_t n, float* rad, int* steps) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  int counts[3] = {0, 0, 0};
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
    for (int k = 0; k < 3; ++k) steps[3 * r + k] = counts[k];
  }
}

// The sun march's and its adjoint's first designs: a thread a point.
__global__ void __launch_bounds__(kDiffThreads) sun_march_point_kernel(
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

template <class Add>
__global__ void __launch_bounds__(kDiffThreads) sun_march_bwd_point_kernel(
    const float* __restrict__ dens, const float* __restrict__ to_sun, ds::diff::Grid3 g, float step,
    float dm, int n_steps, const float* __restrict__ pos, const float* __restrict__ trans,
    const float* __restrict__ g_trans, int64_t n, float* d_dens, float* d_pos, float* d_ts) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float ts[3], q[3], dq[3] = {0.0f, 0.0f, 0.0f}, dts[3] = {0.0f, 0.0f, 0.0f};
  load3(to_sun, 0, ts);
  load3(pos, r, q);
  ds::diff::sun_march_adjoint<false>(dens, g, step, dm, n_steps, q, ts, trans[r], g_trans[r],
                                     d_dens, dq, dts, Add());
  for (int a = 0; a < 3; ++a) {
    d_pos[3 * r + a] = dq[a];
    d_ts[3 * r + a] = dts[a];
  }
}

// The sun march from q (the same on every lane of the group) by its G
// lanes: lane l takes sun step c * G + l of chunk c.  The chunk's span
// comes from a ballot (lane_span: sun_march's continue and break, the cap
// n inside a chunk included) and tau from the lanes' values in step order
// (lane_sum: sun_march's additions in its order; the sample through
// trilinear_strided, taps_value's), so T and *n_in equal sun_march's
// bitwise, on every lane.
template <int G>
__device__ __forceinline__ float sun_march_lanes(const float* __restrict__ dens,
                                                 const ds::diff::Grid3& g, float step, float dm,
                                                 int n, const float* q, const float* ts,
                                                 const GroupLanes& gr, int* n_in) {
  float tau = 0.0f;
  bool was_in = false;
  int count = 0;
  for (int j0 = 0; j0 < n; j0 += G) {
    float s, u[3], xs = 0.0f;
    const bool in = j0 + gr.gl < n && ds::diff::sun_point(g, step, q, ts, j0 + gr.gl, &s, u);
    if (in) xs = (ds::trilinear_strided(dens, g.nx, g.ny, g.nz, u[0], u[1], u[2]) * dm) * step;
    const unsigned bits = __ballot_sync(gr.mask, in) >> gr.shift;
    const ds::diff::LaneSpan sp = ds::diff::lane_span(bits, was_in, G);
    const float x = gr.gl >= sp.start && gr.gl < sp.end ? xs : 0.0f;
    tau = ds::diff::lane_sum<G>(tau, [&](int k) { return __shfl_sync(gr.mask, x, k, G); });
    count += sp.end - sp.start;
    was_in = was_in || sp.start < sp.end;
    if (sp.ended) break;
  }
  *n_in = count;
  return expf(-tau);
}

// sun_march_adjoint<false> by the group's G lanes, lane l on sun
// step c * G + l: each lane's d/dq and d/d to_sun added to dq and dts (the
// caller sums them over the group); the density scatters summed over each
// run of lanes in one cell (group_deposit, keyed by the cell's first
// texel; a lane outside the chunk's span scatters nothing), so a run does
// its eight atomics once.
template <int G, class Add>
__device__ __forceinline__ void sun_march_adjoint_lanes(
    const float* __restrict__ dens, const ds::diff::Grid3& g, float step, float dm, int n,
    const float* q, const float* ts, float T, float gT, float* d_dens, float* dq, float* dts,
    const GroupLanes& gr, const Add& add) {
  const float drho = ((-(gT * T)) * step) * dm;
  if (drho == 0.0f) return;  // the same on every lane of the group
  bool was_in = false;
  for (int j0 = 0; j0 < n; j0 += G) {
    float s, u[3];
    const bool in = j0 + gr.gl < n && ds::diff::sun_point(g, step, q, ts, j0 + gr.gl, &s, u);
    ds::diff::Taps t;
    if (in) t = ds::diff::taps_at(g, u[0], u[1], u[2]);
    const unsigned bits = __ballot_sync(gr.mask, in) >> gr.shift;
    const ds::diff::LaneSpan sp = ds::diff::lane_span(bits, was_in, G);
    float v[8];
    int key = -1 - gr.gl;
    if (gr.gl >= sp.start && gr.gl < sp.end) {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = drho * t.w[k];
      float dp[3];
      ds::diff::taps_point_slope(dens, g, t, drho, dp);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        dq[a] += dp[a];
        dts[a] += dp[a] * s;
      }
      key = t.idx[0];
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = 0.0f;
    }
    group_deposit<G>(gr.mask, gr.gl, gr.shift, key, t.idx, v, d_dens, add);
    was_in = was_in || sp.start < sp.end;
    if (sp.ended) break;
  }
}

// The sun march, G lanes a point: points x G threads.
template <int G>
__global__ void __launch_bounds__(kDiffThreads) sun_march_lanes_kernel(
    const float* __restrict__ dens, const float* __restrict__ to_sun, ds::diff::Grid3 g, float step,
    float dm, int n_steps, const float* __restrict__ pos, int64_t n, float* out, int* steps) {
  const GroupLanes gr = group_lanes<G>();
  const int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (r >= n) return;
  float ts[3], q[3];
  load3(to_sun, 0, ts);
  load3(pos, r, q);
  int n_in;
  const float T = sun_march_lanes<G>(dens, g, step, dm, n_steps, q, ts, gr, &n_in);
  if (gr.gl == 0) {
    out[r] = T;
    if (steps != nullptr) steps[r] = n_in;
  }
}

// The sun march's adjoint, G lanes a point: d/d pos and d/d to_sun summed
// over the group at the end, lane 0 writing.
template <int G, class Add>
__global__ void __launch_bounds__(kDiffThreads) sun_march_bwd_lanes_kernel(
    const float* __restrict__ dens, const float* __restrict__ to_sun, ds::diff::Grid3 g, float step,
    float dm, int n_steps, const float* __restrict__ pos, const float* __restrict__ trans,
    const float* __restrict__ g_trans, int64_t n, float* d_dens, float* d_pos, float* d_ts) {
  const GroupLanes gr = group_lanes<G>();
  const int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (r >= n) return;
  float ts[3], q[3], dq[3] = {0.0f, 0.0f, 0.0f}, dts[3] = {0.0f, 0.0f, 0.0f};
  load3(to_sun, 0, ts);
  load3(pos, r, q);
  sun_march_adjoint_lanes<G>(dens, g, step, dm, n_steps, q, ts, trans[r], g_trans[r], d_dens, dq,
                             dts, gr, Add());
  group_sum3<G>(gr, dq);
  group_sum3<G>(gr, dts);
  if (gr.gl == 0) {
    for (int a = 0; a < 3; ++a) {
      d_pos[3 * r + a] = dq[a];
      d_ts[3 * r + a] = dts[a];
    }
  }
}

template <int G>
static int sun_march_lanes_launch(const float* dens, const float* to_sun, int nx, int ny, int nz,
                                  const float* consts, int n_steps, const float* pos, int64_t n,
                                  float* out, int* steps, void* stream) {
  const ds::diff::Grid3 g = ds::diff::grid3(nx, ny, nz, consts);
  sun_march_lanes_kernel<G><<<blocks_for(n * G), kDiffThreads, 0, (cudaStream_t)stream>>>(
      dens, to_sun, g, consts[3], consts[4], n_steps, pos, n, out, steps);
  return (int)cudaGetLastError();
}

template <int G, class Add>
static int sun_march_bwd_lanes_launch(const float* dens, const float* to_sun, int nx, int ny,
                                      int nz, const float* consts, int n_steps, const float* pos,
                                      const float* trans, const float* g_trans, int64_t n,
                                      float* d_dens, float* d_pos, float* d_ts, void* stream) {
  const ds::diff::Grid3 g = ds::diff::grid3(nx, ny, nz, consts);
  sun_march_bwd_lanes_kernel<G, Add><<<blocks_for(n * G), kDiffThreads, 0, (cudaStream_t)stream>>>(
      dens, to_sun, g, consts[3], consts[4], n_steps, pos, trans, g_trans, n, d_dens, d_pos, d_ts);
  return (int)cudaGetLastError();
}

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

// K8b's forward: march 0 a thread a ray, or G = 4, 8, 16 or 32 lanes a
// ray; the sun march and its adjoint: 0 their first designs, 1 the
// package's thread a point (strided samples; the adjoint's runs merged),
// or G = 8, 16 or 32 lanes a point, the adjoint with ds_diff_variant's
// scatter 2 its scatters left out.
void ds_diff_forward_variant(int march, int sun, int sun_bwd) {
  g_march = march;
  g_sun = sun;
  g_sun_bwd = sun_bwd;
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
#define DS_LANES(G, A) \
  march_bwd_lanes_variant_kernel<G, A><<<blocks_for(n * G), kDiffThreads, 0, s>>>(DS_ARGS)
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

int ds_diff_march(const float* dens, const float* baked, const float* to_sun, int nx, int ny,
                  int nz, const float* consts, int n_steps, int sun_steps, const float* entry,
                  const float* dirs, const float* phase, const uint8_t* hit, int64_t n,
                  float* rad, int* steps, void* stream) {
  if (n <= 0) return 0;
#define DS_ARGS \
  dens, baked, to_sun, nx, ny, nz, consts, n_steps, sun_steps, entry, dirs, phase, hit, n, rad, \
      steps, stream
#define DS_G(G) return march_lanes_launch<G>(DS_ARGS)
  switch (g_march) {
    case 0: {
      const ds::diff::MarchConsts c =
          ds::diff::march_consts(nx, ny, nz, consts, n_steps, sun_steps, baked != nullptr);
      march_ray_kernel<<<blocks_for(n), kDiffThreads, 0, (cudaStream_t)stream>>>(
          dens, baked, to_sun, c, entry, dirs, phase, hit, n, rad, steps);
      return (int)cudaGetLastError();
    }
    case 4: DS_G(4);
    case 8: DS_G(8);
    case 16: DS_G(16);
    case 32: DS_G(32);
    default: return -1;
  }
#undef DS_G
#undef DS_ARGS
}

int ds_sun_march(const float* dens, const float* to_sun, int nx, int ny, int nz,
                 const float* consts, int n_steps, const float* pos, int64_t n, float* out,
                 int* steps, void* stream) {
  if (n <= 0) return 0;
#define DS_G(G) \
  return sun_march_lanes_launch<G>(dens, to_sun, nx, ny, nz, consts, n_steps, pos, n, out, steps, \
                                   stream)
#define DS_ARGS dens, to_sun, nx, ny, nz, consts, n_steps, pos, n, out, steps, stream
  switch (g_sun) {
    case 0: {
      const ds::diff::Grid3 g = ds::diff::grid3(nx, ny, nz, consts);
      sun_march_point_kernel<<<blocks_for(n), kDiffThreads, 0, (cudaStream_t)stream>>>(
          dens, to_sun, g, consts[3], consts[4], n_steps, pos, n, out, steps);
      return (int)cudaGetLastError();
    }
    case 1: return sun_march_launch(DS_ARGS);
    case 8: DS_G(8);
    case 16: DS_G(16);
    case 32: DS_G(32);
    default: return -1;
  }
#undef DS_ARGS
#undef DS_G
}

int ds_sun_march_bwd(const float* dens, const float* to_sun, int nx, int ny, int nz,
                     const float* consts, int n_steps, const float* pos, const float* trans,
                     const float* g_trans, int64_t n, float* d_dens, float* d_pos, float* d_ts,
                     void* stream) {
  if (n <= 0) return 0;
  if (g_scatter != 0 && g_scatter != 2) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const ds::diff::Grid3 g = ds::diff::grid3(nx, ny, nz, consts);
#define DS_POINT(A)                                                                           \
  sun_march_bwd_point_kernel<Scatter<A>><<<blocks_for(n), kDiffThreads, 0, s>>>(             \
      dens, to_sun, g, consts[3], consts[4], n_steps, pos, trans, g_trans, n, d_dens, d_pos, \
      d_ts)
#define DS_BWD(LAUNCH)                                                                     \
  LAUNCH(dens, to_sun, nx, ny, nz, consts, n_steps, pos, trans, g_trans, n, d_dens, d_pos, d_ts, \
         stream)
#define DS_G(G)                                                         \
  return g_scatter ? DS_BWD((sun_march_bwd_lanes_launch<G, Scatter<2>>)) \
                   : DS_BWD((sun_march_bwd_lanes_launch<G, Scatter<0>>))
  switch (g_sun_bwd) {
    case 0:
      if (g_scatter) {
        DS_POINT(2);
      } else {
        DS_POINT(0);
      }
      return (int)cudaGetLastError();
    case 1:
      return g_scatter ? DS_BWD(sun_march_bwd_launch<Scatter<2>>) : DS_BWD(sun_march_bwd_launch<>);
    case 8: DS_G(8);
    case 16: DS_G(16);
    case 32: DS_G(32);
    default: return -1;
  }
#undef DS_G
#undef DS_BWD
#undef DS_POINT
}

}  // extern "C"
