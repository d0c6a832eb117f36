// Designs of the row-gather probe's P1 (csrc/gather_probe.cu), for
// probes/gather.py::variants.  ds_gather_probe here takes the same
// arguments as the package's; ds_gather_design chooses the P1 design:
//
//   0  the first design: a warp a row (rows warp, warp + 8, ...), each lane
//      loading 16-byte vectors at stride 512 B, one row after the other;
//   1  the package's: kRowsInFlight warp steps of loads in flight a lane;
//   2  Hopper's bulk copy: a ring of kRing shared-memory slots a warp, one
//      row a slot, filled by cp.async.bulk (one lane issues it) and
//      signalled by an mbarrier a slot; the warp sums a slot's row from
//      shared memory and refills the slot with the row kRing ahead.  The
//      counterpart of the Pallas kernel's make_async_copy into NBUF VMEM
//      buffers with DMA semaphores.
//
// P2 runs the package's kernel in every design.
#define ds_gather_probe ds_gather_probe_package
#include "gather_probe.cu"
#undef ds_gather_probe

namespace {

int g_design = 1;

constexpr int kRing = 8;
// Polls of a slot's mbarrier before design 2 gives up (a copy that never
// lands); the tile's sum is then written as -1, which no sum equals.
constexpr unsigned kMaxPolls = 1u << 22;

__global__ void __launch_bounds__(kThreads) warp_row_kernel(
    const int32_t* __restrict__ idx, const uint8_t* __restrict__ rows, int64_t width,
    float* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int32_t* tile = idx + (int64_t)blockIdx.x * kTile;
  const int64_t nvec = width / 16;
  unsigned acc = 0;
  for (int j = warp; j < kTile; j += kWarps) {
    const uint4* base = reinterpret_cast<const uint4*>(rows + (int64_t)tile[j] * width);
    acc = warp_span_sum(base, nvec, lane, acc);
  }
  block_write(acc, out);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One arrival (the lane that posts the expected bytes) completes a phase.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(1) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Copy `bytes` from global `src` into shared `dst`; the mbarrier at `bar`
// expects them.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Dynamic shared memory: kWarps x kRing row slots, then kWarps x kRing
// mbarriers.
__global__ void __launch_bounds__(kThreads) bulk_ring_kernel(
    const int32_t* __restrict__ idx, const uint8_t* __restrict__ rows, int64_t width,
    float* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int32_t* tile = idx + (int64_t)blockIdx.x * kTile;
  const int nvec = (int)(width / 16);
  uint8_t* ring = smem + (int64_t)warp * kRing * width;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + (int64_t)kWarps * kRing * width) +
                   warp * kRing;
  const int n_rows = kTile / kWarps;  // rows warp, warp + 8, ...
  auto issue = [&](int i) {
    const int s = i % kRing;
    const uint8_t* src = rows + (int64_t)tile[warp + kWarps * i] * width;
    bulk_load(smem_addr(ring + (int64_t)s * width), src, (uint32_t)width, smem_addr(bars + s));
  };
  if (lane == 0) {
    for (int s = 0; s < kRing; ++s) mbar_init(smem_addr(bars + s));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < kRing && i < n_rows; ++i) issue(i);
  }
  __syncwarp();
  unsigned acc = 0;
  bool failed = false;
  for (int i = 0; i < n_rows; ++i) {
    const int s = i % kRing;
    const uint32_t parity = (uint32_t)((i / kRing) & 1);
    unsigned polls = 0;
    bool timeout = false;
    while (!mbar_try_wait(smem_addr(bars + s), parity)) {
      if (++polls > kMaxPolls) {
        timeout = true;
        break;
      }
    }
    failed = __any_sync(0xffffffffu, timeout);  // the same for every lane
    if (failed) break;
    const uint4* slot = reinterpret_cast<const uint4*>(ring + (int64_t)s * width);
    for (int v = lane; v < nvec; v += 32) acc = sum_bytes(slot[v], acc);
    __syncwarp();
    if (lane == 0 && i + kRing < n_rows) {
      // The slot's generic reads come before the async copy that refills it.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(i + kRing);
    }
  }
  if (failed) acc = 0u;
  block_write(acc, out);
  if (failed && lane == 0) out[blockIdx.x] = -1.0f;
}

}  // namespace

extern "C" {

// P1's design: 0 a warp a row, 1 the package's, 2 the bulk-copy ring.
// Another choice makes ds_gather_probe return -1.
void ds_gather_design(int design) { g_design = design; }

// Shared memory design 2 takes at a row width (0 where the width does not
// fit a block).
int64_t ds_gather_ring_bytes(int64_t width) {
  const int64_t bytes = (int64_t)kWarps * kRing * (width + 8);
  return bytes <= 227 * 1024 ? bytes : 0;
}

int ds_gather_probe(const int32_t* idx, const uint8_t* rows, int64_t width, int64_t ntiles,
                    int run, float* out, void* stream) {
  if (run != 0 || g_design == 1) {
    return ds_gather_probe_package(idx, rows, width, ntiles, run, out, stream);
  }
  if (ntiles <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (g_design == 0) {
    warp_row_kernel<<<(unsigned)ntiles, kThreads, 0, s>>>(idx, rows, width, out);
  } else if (g_design == 2) {
    const int64_t bytes = ds_gather_ring_bytes(width);
    if (bytes == 0) return (int)cudaErrorInvalidValue;
    const int err = (int)cudaFuncSetAttribute(
        bulk_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != 0) return err;
    bulk_ring_kernel<<<(unsigned)ntiles, kThreads, (size_t)bytes, s>>>(idx, rows, width, out);
  } else {
    return -1;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
