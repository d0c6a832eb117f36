// Alternatives of K9, the slab march (csrc/spatial.cu), for
// probes/march_variants.py --spatial-only and chip_smoke.py's parallel
// phase: its first design, a thread a ray marching step by step
// (csrc/spatial_first.cuh's phase_ray, 128-thread blocks, a grid over the
// rays); the package's kernel at a given number of lanes a ray (G = 1, 4,
// 8, 16, 32, in place of the package's choice from the alive count), and
// with launch bounds of the threads alone or of 12 resident blocks a SM in
// place of the package's 1, with other chunks between refills, and
// scanning the rays in order.  Every alternative computes the package's
// records bitwise.
//
// A source of its own: it includes only csrc/spatial.cu and the first
// design's header, so chip_smoke.py builds it beside the package's
// sources.  The package's entry points are renamed where they are
// included; the ds_spatial_phase here takes the same arguments and runs
// the alternative ds_spatial_variant chose, so the wrapper's lib= argument
// drives it.
#define ds_spatial_phase ds_spatial_phase_package
#define ds_spatial_registers ds_spatial_registers_package
#define ds_spatial_lanes ds_spatial_lanes_package
#define ds_spatial_scan ds_spatial_scan_package
#define ds_spatial_chunks ds_spatial_chunks_package
#include "spatial.cu"
#undef ds_spatial_phase
#undef ds_spatial_registers
#undef ds_spatial_lanes
#undef ds_spatial_scan
#undef ds_spatial_chunks
#include "spatial_first.cuh"

namespace {

// The first design (g_design 0) or the package's kernel (1) at g_lanes
// lanes a ray (0: the package's choice) with launch bounds of g_blocks
// resident blocks a SM (0: the threads alone; 1, the package's
// kSpatialBlocks; 12).
int g_design = 1;
int g_lanes = 0;
int g_blocks = ds::spatial::kSpatialBlocks;
int g_chunks = 0;  // chunks a group marches between refills (0: the package's)

}  // namespace

// The first design: a thread a ray.
template <typename T>
__global__ void __launch_bounds__(ds::spatial::kSpatialThreads) spatial_first_kernel(
    ds::spatial::SlabArgs<T> a, int z0, int slab, int steps) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= a.n) return;
  ds::spatial::phase_ray(r, a.dens, a.insc, a.nx, a.ny, a.nz, z0, slab, a.zm, a.eval_rows, a.inv,
                         a.c, a.seed, a.ids, steps, a.rec_in, a.rec_out);
}

// The package's kernel with launch bounds of B resident blocks a SM, or
// of the threads alone.
template <int G, typename T, int B>
__global__ void __launch_bounds__(ds::spatial::kSpatialThreads, B) spatial_bounded_kernel(
    ds::spatial::SlabArgs<T> a) {
  ds::spatial::phase_items<G>(a);
}

template <int G, typename T>
__global__ void __launch_bounds__(ds::spatial::kSpatialThreads) spatial_threads_kernel(
    ds::spatial::SlabArgs<T> a) {
  ds::spatial::phase_items<G>(a);
}

// The package's kernel scanning the rays in order at every G.
template <int G, typename T>
__global__ void __launch_bounds__(ds::spatial::kSpatialThreads, ds::spatial::kSpatialBlocks)
    spatial_in_order_kernel(ds::spatial::SlabArgs<T> a) {
  ds::spatial::phase_items<G, false>(a);
}

namespace {

template <int G, typename T>
int launch_variant(const ds::spatial::SlabArgs<T>& a, cudaStream_t s) {
  static int per_sm[4] = {0, 0, 0, 0};
  if (g_design == 2) return launch_items(spatial_in_order_kernel<G, T>, G, &per_sm[3], a, s);
  switch (g_blocks) {
    case 0: return launch_items(spatial_threads_kernel<G, T>, G, &per_sm[0], a, s);
    case ds::spatial::kSpatialBlocks: return launch_items(spatial_items_kernel<G, T>, G, &per_sm[1], a, s);
    case 12: return launch_items(spatial_bounded_kernel<G, T, 12>, G, &per_sm[2], a, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run_variant(int lanes, const ds::spatial::SlabArgs<T>& a, int z0, int slab, int steps,
                cudaStream_t s) {
  if (g_design == 0) {
    const cudaError_t e = cudaMemsetAsync(a.counters, 0, 2 * sizeof(unsigned long long), s);
    if (e != cudaSuccess) return (int)e;
    const unsigned blocks = (unsigned)((a.n + ds::spatial::kSpatialThreads - 1) /
                                       ds::spatial::kSpatialThreads);
    spatial_first_kernel<T><<<blocks, ds::spatial::kSpatialThreads, 0, s>>>(a, z0, slab, steps);
    return (int)cudaGetLastError();
  }
  ds::spatial::SlabArgs<T> b = a;
  if (g_chunks > 0) b.chunks = g_chunks;
  switch (lanes) {
    case 1: return launch_variant<1>(b, s);
    case 4: return launch_variant<4>(b, s);
    case 8: return launch_variant<8>(b, s);
    case 16: return launch_variant<16>(b, s);
    case 32: return launch_variant<32>(b, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename F>
int registers_of(F kernel) {
  cudaFuncAttributes a;
  return cudaFuncGetAttributes(&a, kernel) == cudaSuccess ? a.numRegs : -1;
}

template <int G>
int variant_registers(int blocks) {
  switch (blocks) {
    case 0: return registers_of(spatial_threads_kernel<G, uint8_t>);
    case ds::spatial::kSpatialBlocks: return registers_of(spatial_items_kernel<G, uint8_t>);
    case 12: return registers_of(spatial_bounded_kernel<G, uint8_t, 12>);
  }
  return -1;
}

}  // namespace

// Chooses the alternative: design 0 the first design, 1 the package's
// kernel (2: scanning the rays in order at every G, with its launch bounds)
// at `lanes` lanes a ray (0: the package's choice) with launch
// bounds of `blocks` resident blocks a SM (0: the threads alone; 1, the
// package's), its groups marching `chunks` chunks between refills (0: the
// package's).
extern "C" void ds_spatial_variant(int design, int lanes, int blocks, int chunks) {
  g_design = design;
  g_lanes = lanes;
  g_blocks = blocks;
  g_chunks = chunks;
}

// ds_spatial_phase's arguments; runs the chosen alternative.
extern "C" int ds_spatial_phase(const void* dens, const void* insc, int is_u8, int nx,
                                int ny, int nz, int z0, int slab, int halo,
                                const float* eval_rows, int n_phase, const float* inv_rows,
                                int n_inv, const float* consts, const float* ground,
                                int max_depth, int rr_start, int flags, uint32_t seed,
                                const int64_t* ids, int64_t n, int64_t n_alive, int steps,
                                const float* rec_in, float* rec_out,
                                unsigned long long* counters, void* stream) {
  if (n <= 0) return 0;
  const ds::PtConsts c =
      ds::pt_consts(consts, ground, 0, max_depth, rr_start, n_phase, n_inv, flags);
  const int lanes = g_lanes > 0 ? g_lanes : ds_spatial_lanes_package(n, n_alive);
  const int scan = ds_spatial_scan_package(n, n_alive, lanes);
  const int chunks = ds_spatial_chunks_package(lanes);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_u8) {
    return run_variant(lanes, slab_args<uint8_t>(dens, insc, nx, ny, nz, z0, slab, halo,
                                                 eval_rows, inv_rows, c, seed, ids, n, scan,
                                                 chunks, steps, rec_in, rec_out, counters),
                       z0, slab, steps, s);
  }
  return run_variant(lanes, slab_args<float>(dens, insc, nx, ny, nz, z0, slab, halo, eval_rows,
                                             inv_rows, c, seed, ids, n, scan, chunks, steps,
                                             rec_in, rec_out, counters),
                     z0, slab, steps, s);
}

// The registers a thread of an alternative on uint8 textures takes (design
// 0 the first design; else the kernel at `lanes` lanes a ray with launch
// bounds of `blocks` blocks), or -1.
extern "C" int ds_spatial_registers(int design, int lanes, int blocks) {
  if (design == 0) return registers_of(spatial_first_kernel<uint8_t>);
  switch (lanes) {
    case 1: return variant_registers<1>(blocks);
    case 4: return variant_registers<4>(blocks);
    case 8: return variant_registers<8>(blocks);
    case 16: return variant_registers<16>(blocks);
    case 32: return variant_registers<32>(blocks);
  }
  return -1;
}
