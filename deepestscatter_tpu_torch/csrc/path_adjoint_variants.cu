// Alternatives of K8c, the path adjoint (csrc/path_adjoint.cu), for
// probes/march_variants.py --path-only and chip_smoke.py's ms diff phase:
// its first design, a thread a (sample, pixel) item doing both passes
// (csrc/path_adjoint_first.cuh's adjoint_item: the replay at lookahead 1
// into the flights, then the sweep, each flight re-marched by one thread);
// the package's two kernels at other lanes a sample (G = 4, 16, 32) and
// with the replay's launch bounds asking for no resident blocks a SM (the
// threads alone); the package's sweep with launch bounds of 6 resident
// blocks a SM, with its grid scatters aimed at a scratch slot of its own a
// thread (the atomics issued, no texel shared) or left out (the values
// computed, nothing added), and timed entry by entry.  Every alternative
// with its scatters in place computes what the package's kernels compute:
// the records bitwise, the gradients within the float32 rounding of their
// sums' order and the atomics'.
//
// A source of its own: it includes only csrc/path_adjoint.cu and the first
// design's header, so chip_smoke.py builds it beside the package's
// sources.  The package's entry points are renamed where they are
// included; the ds_path_adjoint(_blocks) here take the same arguments and
// run the alternative ds_path_variant chose, so the wrapper's lib=
// argument drives them.
#define ds_path_adjoint ds_path_adjoint_package
#define ds_path_adjoint_blocks ds_path_adjoint_blocks_package
#define ds_path_registers ds_path_registers_package
#include "path_adjoint.cu"
#undef ds_path_adjoint
#undef ds_path_adjoint_blocks
#undef ds_path_registers
#include "path_adjoint_first.cuh"

namespace {

// The first design (g_first), or the replay and the sweep at g_lanes lanes
// a sample, the replay's launch bounds at g_blocks resident blocks a SM (0:
// the threads alone).
bool g_first = false;
int g_lanes = ds::path::kSweepLanes;
int g_blocks = ds::path::kReplayBlocks;
// The sweep at the package's lanes: -1 the package's kernel; 6 its launch
// bounds at 6 resident blocks a SM; 101 its scatters aimed at a scratch
// slot a thread, 102 left out; 200 timed (g_timeline).
int g_sweep = -1;
// Where g_sweep is 200: the package's sweep timed entry by entry into
// g_timeline (path_sweep_timed_kernel).
unsigned long long* g_timeline = nullptr;

constexpr int kScratch = 1 << 16;
__device__ double g_scratch64[kScratch];

// The sweep's grid scatters for g_sweep = 100 + A.
template <int A>
struct Scatter {
  template <typename G>
  __device__ __forceinline__ void operator()(G* p, float v) const {
    if (v == 0.0f) return;
    if (A == 1) {
      const unsigned slot = (blockIdx.x * blockDim.x + threadIdx.x) & (kScratch - 1);
      atomicAdd(g_scratch64 + slot, (double)v);
    } else if (v != v) {  // never for a finite v: keeps v computed
      g_scratch64[0] = v;
    }
  }
};

}  // namespace

// The first design: a thread an item (adjoint_item); partials[6 * block]:
// the block's light gradients.
__global__ void __launch_bounds__(ds::path::kThreads) path_adjoint_kernel(ds::path::PathArgs a) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  ds::path::LightGrads L = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  if (i < a.n_items) ds::path::adjoint_item(a, i, L, ds::diff::AddTo());
  double v[6];
  for (int j = 0; j < 3; ++j) {
    v[j] = L.dir[j];
    v[3 + j] = L.rad[j];
  }
  ds::path::block_sum6(v, a.partials + 6 * (int64_t)blockIdx.x);
}

// The replay with launch bounds of threads alone.
__global__ void __launch_bounds__(ds::path::kThreads) path_replay_threads_kernel(
    ds::path::PathArgs a) {
  ds::path::replay_items(a);
}

// The sweep at G lanes a sample, launch bounds of MinBlocks resident blocks
// a SM, and the scatters of code 100 + A (A = 0: the grids' atomics).
template <int G, int MinBlocks, int A>
__global__ void __launch_bounds__(ds::path::kThreads, MinBlocks) path_sweep_variant_kernel(
    ds::path::PathArgs a) {
  if (A == 0) {
    ds::path::sweep_items<G>(a, ds::diff::AddTo());
  } else {
    ds::path::sweep_items<G>(a, Scatter<A>());
  }
}

// The package's sweep with each entry's start and end on the card's global
// timer: timeline[4 e ..] = (start ns, end ns, the entry, the group's SM).
__global__ void __launch_bounds__(ds::path::kThreads, ds::path::kSweepBlocks)
    path_sweep_timed_kernel(ds::path::PathArgs a, unsigned long long* timeline) {
  constexpr int G = ds::path::kSweepLanes;
  const GroupLanes gr = group_lanes<G>();
  const unsigned long long n_front = a.counters[1], len = n_front + a.counters[3];
  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (;;) {
    unsigned long long e = 0;
    if (gr.gl == 0) e = atomicAdd(&a.counters[2], 1ull);
    e = __shfl_sync(gr.mask, e, 0, G);
    if (e >= len) break;
    unsigned long long t0, t1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    const int64_t entry = ds::path::list_at(a, n_front, e);
    ds::path::sweep_entry<G>(a, gr, entry, acc, ds::diff::AddTo());
    __syncwarp(gr.mask);
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
    if (gr.gl == 0) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      timeline[4 * e] = t0;
      timeline[4 * e + 1] = t1;
      timeline[4 * e + 2] = (unsigned long long)entry;
      timeline[4 * e + 3] = sm;
    }
  }
  ds::path::block_sum6(acc, a.partials + 6 * (int64_t)blockIdx.x);
}

static int64_t first_blocks(int64_t n_items) {
  return (n_items + ds::path::kThreads - 1) / ds::path::kThreads;
}

typedef void (*PathKernel)(ds::path::PathArgs);

// The chosen sweep kernel (NULL for a code outside the built ones).
static PathKernel sweep_kernel() {
  constexpr int B = ds::path::kSweepBlocks;
  if (g_lanes != ds::path::kSweepLanes) {
    if (g_sweep >= 0) return nullptr;
    switch (g_lanes) {
      case 4: return path_sweep_variant_kernel<4, B, 0>;
      case 16: return path_sweep_variant_kernel<16, B, 0>;
      case 32: return path_sweep_variant_kernel<32, B, 0>;
      default: return nullptr;
    }
  }
  switch (g_sweep) {
    case -1:
    case 200: return path_sweep_kernel;
    case 6: return path_sweep_variant_kernel<ds::path::kSweepLanes, 6, 0>;
    case 101: return path_sweep_variant_kernel<ds::path::kSweepLanes, B, 1>;
    case 102: return path_sweep_variant_kernel<ds::path::kSweepLanes, B, 2>;
    default: return nullptr;
  }
}

// The chosen replay kernel (NULL for a code outside the built ones).
static PathKernel replay_kernel() {
  switch (g_blocks) {
    case 0: return path_replay_threads_kernel;
    case ds::path::kReplayBlocks: return path_replay_kernel;
    default: return nullptr;
  }
}

// The chosen sweep's blocks for n_items items.
static int sweep_variant_blocks(int64_t n_items, unsigned* blocks) {
  const PathKernel kernel = sweep_kernel();
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  return sweep_grid(kernel, g_lanes, &per_sm, n_items, blocks);
}

// The chosen replay, then the chosen sweep.
static int two_kernels(const ds::path::PathArgs& a, cudaStream_t s) {
  const PathKernel replay = replay_kernel();
  if (replay == nullptr) return (int)cudaErrorInvalidValue;
  int err = (int)cudaMemsetAsync(a.counters, 0, 4 * sizeof(unsigned long long), s);
  if (err != 0) return err;
  int per_sm = 0;
  unsigned blocks = 0;
  err = replay_grid(replay, &per_sm, a.n_items, &blocks);
  if (err != 0) return err;
  replay<<<blocks, ds::path::kThreads, 0, s>>>(a);
  err = (int)cudaGetLastError();
  if (err == 0) err = sweep_variant_blocks(a.n_items, &blocks);
  if (err != 0) return err;
  if (g_sweep == 200) {
    if (g_timeline == nullptr) return (int)cudaErrorInvalidValue;
    path_sweep_timed_kernel<<<blocks, ds::path::kThreads, 0, s>>>(a, g_timeline);
  } else {
    sweep_kernel()<<<blocks, ds::path::kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" {

// design 0: the first design (the other arguments unused); design 1: the
// replay and the sweep at `lanes` lanes a sample (4, 8, 16 or 32), the
// replay's launch bounds at `blocks` resident blocks a SM (0, or -1 for the
// package's kReplayBlocks), the sweep at `sweep` (-1 the kernel of those;
// at the package's lanes: 6 resident blocks a SM in its launch bounds, 101
// its scatters into a scratch slot a thread, 102 none, 200 the package's
// timed entry by entry into ds_path_timeline's buffer).  A code outside
// these makes the launch fail.
void ds_path_variant(int design, int lanes, int blocks, int sweep) {
  g_first = design == 0;
  g_lanes = lanes;
  g_blocks = blocks < 0 ? ds::path::kReplayBlocks : blocks;
  g_sweep = sweep;
}

int64_t ds_path_adjoint_blocks(int64_t m, int n_samples) {
  const int64_t n_items = m * (int64_t)n_samples;
  if (g_first) return first_blocks(n_items);
  unsigned blocks = 0;
  return sweep_variant_blocks(n_items, &blocks) != 0 ? -1 : (int64_t)blocks;
}

// The timeline of the sweep ds_path_variant's sweep code 200 times:
// 4 x the launch's items uint64 on the card.
void ds_path_timeline(unsigned long long* timeline) { g_timeline = timeline; }

// ds_path_adjoint's arguments; runs the alternative ds_path_variant chose.
int ds_path_adjoint(const float* dens, const float* insc, int nx, int ny, int nz,
                    const float* eval_rows, int n_phase, const float* inv_rows, int n_inv,
                    const float* entry, const float* dirs, const uint8_t* hit,
                    const int64_t* ray_ids, int64_t n, int64_t r0, int64_t m,
                    const float* consts, const float* ground, int max_steps, int max_depth,
                    int rr_start, int flags, uint32_t seed_base, uint32_t sub_first,
                    int n_samples, const float* g_rec, void* scratch, int max_segments,
                    unsigned long long* counters, float* rec_rad, int32_t* rec_work,
                    double* d_dens, double* d_insc, float* d_entry, float* d_dirs,
                    int32_t* remarch, double* partials, void* stream) {
  if (m * (int64_t)n_samples <= 0) return 0;
  ds::path::PathArgs a;
  if (!ds::path::path_args(&a, dens, insc, nx, ny, nz, eval_rows, n_phase, inv_rows, n_inv,
                           entry, dirs, hit, ray_ids, n, r0, m, consts, ground, max_steps,
                           max_depth, rr_start, flags, seed_base, sub_first, n_samples, g_rec,
                           scratch, max_segments, counters, rec_rad, rec_work, d_dens, d_insc,
                           d_entry, d_dirs, remarch, partials)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (!g_first) return two_kernels(a, s);
  path_adjoint_kernel<<<(unsigned)first_blocks(a.n_items), ds::path::kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// The registers a thread takes: kernel 0 the chosen replay, 1 the chosen
// sweep, 2 the first design; -1 for another code.
int ds_path_registers(int kernel) {
  const PathKernel k = kernel == 2 ? path_adjoint_kernel
                                   : (kernel == 0 ? replay_kernel() : sweep_kernel());
  return k == nullptr ? -1 : kernel_registers(k);
}

}  // extern "C"
