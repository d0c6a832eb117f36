// P1 / P2: the row-gather probe, one CTA per 1024-row tile.
//
// Replaces the Pallas kernels of tools/pallas_gather_probe.py:
// _per_lane_kernel (line 39, P1) and _coalesced_kernel (line 79, P2), both
// called through build() at pl.pallas_call (line 139).  The probe measures
// the card's rate for gathering rows of a uint8 table by a random int32
// index, the access pattern of the march kernels, and the rate when the
// same rows come as runs of contiguous rows (the best case a binning pass
// could make).
//
// P1: tile t sums the bytes of the rows idx[t*1024 + j], j < 1024.  A warp
// takes one row at a time (rows warp, warp + 8, ...), each lane loading
// 16-byte vectors at stride 512 B; bytes are summed with dp4a into an
// int32 (at most 1024 * 1024 * 255 < 2^31, so the sum is exact), reduced
// over the warp and the block, and written as one float32 per tile.
// P2: the same over blocks of `run` contiguous rows starting at
// idx[t*1024 + b], b < 1024 / run; the rest of each tile's 1024 index
// entries is padding and is not read (the Pallas kernel's layout).
//
// The TPU kernel's DMA slots, semaphores, pipeline depth and its 1024-byte
// slice limit have no counterpart here: the warps' independent loads are
// the pipeline.  Rows must be a multiple of 16 bytes wide and the table
// 16-byte aligned.  Bound on the card: bytes, batch * width at the HBM
// rate (the 128 MB and 1 GB tables exceed the 50 MB L2).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ unsigned sum_bytes(uint4 v, unsigned acc) {
  acc = __dp4a(v.x, 0x01010101u, acc);
  acc = __dp4a(v.y, 0x01010101u, acc);
  acc = __dp4a(v.z, 0x01010101u, acc);
  return __dp4a(v.w, 0x01010101u, acc);
}

// Sum of `nvec` 16-byte vectors from `base`, over the lanes of one warp.
__device__ __forceinline__ unsigned warp_span_sum(const uint4* __restrict__ base,
                                                  int64_t nvec, int lane,
                                                  unsigned acc) {
  for (int64_t v = lane; v < nvec; v += 32) acc = sum_bytes(__ldg(base + v), acc);
  return acc;
}

__device__ __forceinline__ void block_write(unsigned acc, float* __restrict__ out) {
  __shared__ unsigned part[kWarps];
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
    for (int w = 0; w < kWarps; ++w) total += part[w];
    out[blockIdx.x] = (float)(int)total;
  }
}

__global__ void __launch_bounds__(kThreads) per_lane_kernel(
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

__global__ void __launch_bounds__(kThreads) coalesced_kernel(
    const int32_t* __restrict__ idx, const uint8_t* __restrict__ rows, int64_t width,
    int run, float* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int32_t* tile = idx + (int64_t)blockIdx.x * kTile;
  const int nblocks = kTile / run;
  const int64_t nvec = (int64_t)run * width / 16;
  unsigned acc = 0;
  for (int b = warp; b < nblocks; b += kWarps) {
    const uint4* base = reinterpret_cast<const uint4*>(rows + (int64_t)tile[b] * width);
    acc = warp_span_sum(base, nvec, lane, acc);
  }
  block_write(acc, out);
}

}  // namespace

// idx: int32 [ntiles * 1024]; rows: uint8 [nrows * width]; out: float32
// [ntiles].  run == 0 selects P1 (per-lane rows), run > 0 P2 (blocks of
// `run` contiguous rows; 1024 % run == 0).  Returns cudaGetLastError()
// after the launch.
extern "C" int ds_gather_probe(const int32_t* idx, const uint8_t* rows, int64_t width,
                               int64_t ntiles, int run, float* out, void* stream) {
  if (ntiles <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (run == 0) {
    per_lane_kernel<<<(unsigned)ntiles, kThreads, 0, s>>>(idx, rows, width, out);
  } else {
    coalesced_kernel<<<(unsigned)ntiles, kThreads, 0, s>>>(idx, rows, width, run, out);
  }
  return (int)cudaGetLastError();
}
