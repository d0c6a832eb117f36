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
// P1: tile t sums the bytes of the rows idx[t*1024 + j], j < 1024.  Bytes
// are summed with dp4a into an int32 (at most 1024 * 1024 * 255 < 2^31, so
// the sum is exact), reduced over the warp and the block, and written as
// one float32 per tile.  A row takes L lanes, L the largest power of two
// up to 32 and up to its 16-byte vectors (a 1 KB row a warp, a 16-B row a
// lane), so a warp step covers 32 / L rows.  Each lane keeps the loads of
// kRowsInFlight steps in flight (kVecsPerRow 16-byte vectors of each row)
// before it sums any of them: the counterpart of the TPU kernel's NBUF = 8
// DMAs in flight (pallas_gather_probe.py:36,59-69).
// P2: the same sums over blocks of `run` contiguous rows starting at
// idx[t*1024 + b], b < 1024 / run; the rest of each tile's 1024 index
// entries is padding and is not read (the Pallas kernel's layout).  A warp
// takes one block at a time, each lane loading 16-byte vectors at stride
// 512 B.
//
// Bound on the card: bytes, batch * width at the HBM rate (the 128 MB and
// 1 GB tables exceed the 50 MB L2).  Only 256 CTAs run a 2^18-row batch,
// about two an SM, so the bytes in flight an SM are set by the loads each
// lane issues before it waits: the first design (a warp a row, one 16-byte
// load a lane in flight, 512 B a warp) reached 48 % of the bound on the
// 1 GB table (0.1479 ms against 0.0712 on an H100 at 700 W); 8 rows of
// 1 KB keep 8 KB a warp in flight.
// csrc/gather_variants.cu times the first design and a Hopper bulk-copy ring
// (cp.async.bulk into 8 shared-memory slots a warp) beside this one.
// Rows must be a multiple of 16 bytes wide and the table 16-byte aligned.
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

constexpr int kRowsInFlight = 8;
constexpr int kVecsPerRow = 2;

// P1.  lane_shift = log2(L).  Warp w takes the tile's warp steps (groups
// of 32 / L consecutive rows) w, w + 8, ..., kRowsInFlight at a time.
__global__ void __launch_bounds__(kThreads) per_lane_kernel(
    const int32_t* __restrict__ idx, const uint8_t* __restrict__ rows, int64_t width,
    int lane_shift, float* __restrict__ out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int32_t* tile = idx + (int64_t)blockIdx.x * kTile;
  const int nvec = (int)(width / 16);
  const int lanes = 1 << lane_shift;      // lanes a row
  const int sub = lane & (lanes - 1);     // this lane's place in its row
  const int per_step = 32 >> lane_shift;  // rows a warp step
  const int steps = kTile / per_step;
  const int slot = lane >> lane_shift;
  // Every load is issued unconditionally, so that all of a group's loads
  // can be in flight at once: a step past the tile re-reads the table's
  // first row and a vector past the row re-reads its last, and both are
  // masked out of the sum.
  const uint4 zero = make_uint4(0, 0, 0, 0);
  unsigned acc = 0;
  for (int g0 = warp; g0 < steps; g0 += kWarps * kRowsInFlight) {
    const uint4* row[kRowsInFlight];
    bool live[kRowsInFlight];
#pragma unroll
    for (int r = 0; r < kRowsInFlight; ++r) {
      const int g = g0 + r * kWarps;
      live[r] = g < steps;
      const int64_t j = live[r] ? tile[g * per_step + slot] : 0;
      row[r] = reinterpret_cast<const uint4*>(rows + j * width);
    }
    for (int v0 = sub; v0 < nvec; v0 += lanes * kVecsPerRow) {
      uint4 x[kRowsInFlight][kVecsPerRow];
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
#pragma unroll
        for (int k = 0; k < kVecsPerRow; ++k) {
          const int v = v0 + k * lanes;
          x[r][k] = __ldg(row[r] + (v < nvec ? v : nvec - 1));
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsInFlight; ++r) {
#pragma unroll
        for (int k = 0; k < kVecsPerRow; ++k) {
          acc = sum_bytes(live[r] && v0 + k * lanes < nvec ? x[r][k] : zero, acc);
        }
      }
    }
  }
  block_write(acc, out);
}

// log2 of the lanes a row of `width` bytes takes: the largest power of two
// up to 32 and up to its 16-byte vectors.
inline int row_lane_shift(int64_t width) {
  int shift = 0;
  while (shift < 5 && (int64_t)16 << (shift + 1) <= width) ++shift;
  return shift;
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
    per_lane_kernel<<<(unsigned)ntiles, kThreads, 0, s>>>(idx, rows, width,
                                                         row_lane_shift(width), out);
  } else {
    coalesced_kernel<<<(unsigned)ntiles, kThreads, 0, s>>>(idx, rows, width, run, out);
  }
  return (int)cudaGetLastError();
}
