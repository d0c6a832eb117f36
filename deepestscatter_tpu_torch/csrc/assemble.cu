// K10: training batch assembly, the trainers' device-resident batches.
//
// Replaces the XLA device programs of deepestscatter_tpu/train/
// device_data.py::DeviceDisneyData.assemble (lines 86-94) and
// DeviceBakedData.assemble (lines 143-172): rows of uint8 descriptor
// tables gathered by an index vector, dequantized by / 256 (exact), and
// written as the networks' float32 inputs.
//
//   RPNN  (ds_assemble_disney): z [B, L, 226] = the row's L layers of 225
//         bytes / 256 with omega in column 225 (L = 10); labels [B].
//   Baked (ds_assemble_baked): probe descriptors [B, 4, Lb, 225] = the
//         row's 4 corners x Lb layers / 256 (the table keeps a row's four
//         corners together, so this is the row / 256 as it lies);
//         realtime [B, Lr, 226] = Lr layers / 256 with omega appended;
//         powers [B, 4], omega, alpha and labels [B] gathered as they are.
//
// assemble_value is the element: train/device_data.py::assemble_*_plain
// computes the same (index_select, float, true_div by 256, cat), so the
// kernel equals its plain version bitwise.  An index outside [0, n) gives
// a row of NaN (the XLA gather's fill; the trainers' NaN abort stops on it)
// and reads nothing.
//
// Bound: bytes.  Each row is read once and each output written once; at the
// reference batch of 1,024 the RPNN layout moves 2.30 MB in and 9.26 MB
// out (3.5 us at 3.35 TB/s), the baked layout 8.98 MB in and 36.0 MB out
// (13.4 us).  Design: a block of kAssembleThreads threads per batch row.
// The block stages the row in shared memory through aligned 16-byte loads
// of the 16-byte words that cover it (rows are 2,250, 8,100 and 675 bytes,
// so they start at any alignment; a 16-byte word that holds a byte of the
// table lies inside its allocation), then writes the row's output as
// consecutive vectors, float4 where the output row is 16-byte aligned
// (RPNN 9,040 B, probes 32,400 B), else float2 (realtime 2,712 B) or float:
// consecutive threads store consecutive vectors.
#include <stdint.h>

#ifndef DS_HOST_EMULATION
#include <cuda_runtime.h>
#endif

namespace ds {

constexpr int kAssembleLayer = 225;
constexpr int kAssembleThreads = 256;

// Output element j of a row whose layers are `width` floats wide, from the
// row's bytes: width 225 is byte j / 256; width 226 is layer l = j / 226,
// column c = j % 226: byte l * 225 + c / 256, and omega in column 225.
__device__ __forceinline__ float assemble_value(const uint8_t* row, int j, int width,
                                                float omega) {
  if (width == kAssembleLayer) return (float)row[j] / 256.0f;
  const int l = j / (kAssembleLayer + 1);
  const int c = j - l * (kAssembleLayer + 1);
  return c == kAssembleLayer ? omega : (float)row[l * kAssembleLayer + c] / 256.0f;
}

}  // namespace ds

#ifndef DS_HOST_EMULATION
namespace {

// 16-byte words covering `nbytes` bytes from any address.
__host__ __device__ inline int stage_words(int nbytes) { return (nbytes + 15) / 16 + 1; }

// Copies the bytes at `src` into `stage` through aligned 16-byte loads
// (the caller synchronises); returns where the first byte lands.
__device__ __forceinline__ const uint8_t* stage_row(const uint8_t* src, int nbytes,
                                                    uint4* stage) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a0 = a & ~uintptr_t(15);
  const int words = (int)((a + nbytes - a0 + 15) >> 4);
  const uint4* w = reinterpret_cast<const uint4*>(a0);
  for (int i = threadIdx.x; i < words; i += blockDim.x) stage[i] = __ldg(w + i);
  return reinterpret_cast<const uint8_t*>(stage) + (a - a0);
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[1]) { p[0] = v[0]; }
__device__ __forceinline__ void store_vec(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Vectors of V outputs: thread t stores vectors t, t + blockDim.x, ...
template <int V>
__device__ __forceinline__ void emit_vectors(float* out, int n, const uint8_t* row, int width,
                                             float omega) {
  for (int q = threadIdx.x; q < n / V; q += blockDim.x) {
    float v[V];
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = ds::assemble_value(row, q * V + k, width, omega);
    store_vec(out + q * V, v);
  }
}

// A row's `n` outputs at `out`, in the widest vectors its alignment allows.
__device__ __forceinline__ void emit(float* out, int n, const uint8_t* row, int width,
                                     float omega) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(out);
  if (a % 16 == 0 && n % 4 == 0) {
    emit_vectors<4>(out, n, row, width, omega);
  } else if (a % 8 == 0 && n % 2 == 0) {
    emit_vectors<2>(out, n, row, width, omega);
  } else {
    emit_vectors<1>(out, n, row, width, omega);
  }
}

__device__ __forceinline__ void fill_nan(float* out, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) out[j] = __int_as_float(0x7fc00000);
}

__global__ void __launch_bounds__(ds::kAssembleThreads)
assemble_disney_kernel(const uint8_t* __restrict__ grids, const float* __restrict__ omega,
                       const float* __restrict__ labels, int64_t n,
                       const int64_t* __restrict__ idx, int layers, float* __restrict__ z,
                       float* __restrict__ lab) {
  extern __shared__ uint4 stage[];
  const int b = blockIdx.x;
  const int in_bytes = layers * ds::kAssembleLayer;
  const int out_n = layers * (ds::kAssembleLayer + 1);
  float* out = z + (int64_t)b * out_n;
  const int64_t r = idx[b];
  if (r < 0 || r >= n) {  // uniform over the block
    fill_nan(out, out_n);
    if (threadIdx.x == 0) lab[b] = __int_as_float(0x7fc00000);
    return;
  }
  const uint8_t* row = stage_row(grids + r * in_bytes, in_bytes, stage);
  __syncthreads();
  emit(out, out_n, row, ds::kAssembleLayer + 1, omega[r]);
  if (threadIdx.x == 0) lab[b] = labels[r];
}

__global__ void __launch_bounds__(ds::kAssembleThreads)
assemble_baked_kernel(const uint8_t* __restrict__ probes, const uint8_t* __restrict__ rt,
                      const float* __restrict__ powers, const float* __restrict__ omega,
                      const float* __restrict__ alpha, const float* __restrict__ labels,
                      int64_t n, const int64_t* __restrict__ idx, int probe_layers,
                      int rt_layers, float* __restrict__ probe_out, float* __restrict__ rt_out,
                      float* __restrict__ powers_out, float* __restrict__ omega_out,
                      float* __restrict__ alpha_out, float* __restrict__ lab) {
  extern __shared__ uint4 stage[];
  const int b = blockIdx.x;
  const int probe_n = 4 * probe_layers * ds::kAssembleLayer;
  const int rt_bytes = rt_layers * ds::kAssembleLayer;
  const int rt_n = rt_layers * (ds::kAssembleLayer + 1);
  float* pout = probe_out + (int64_t)b * probe_n;
  float* rout = rt_out + (int64_t)b * rt_n;
  const int64_t r = idx[b];
  if (r < 0 || r >= n) {  // uniform over the block
    fill_nan(pout, probe_n);
    fill_nan(rout, rt_n);
    if (threadIdx.x < 4) powers_out[(int64_t)b * 4 + threadIdx.x] = __int_as_float(0x7fc00000);
    if (threadIdx.x == 0) {
      omega_out[b] = alpha_out[b] = lab[b] = __int_as_float(0x7fc00000);
    }
    return;
  }
  const uint8_t* prow = stage_row(probes + r * probe_n, probe_n, stage);
  const uint8_t* rrow = stage_row(rt + r * rt_bytes, rt_bytes, stage + stage_words(probe_n));
  __syncthreads();
  const float om = omega[r];
  emit(pout, probe_n, prow, ds::kAssembleLayer, om);
  emit(rout, rt_n, rrow, ds::kAssembleLayer + 1, om);
  if (threadIdx.x < 4) powers_out[(int64_t)b * 4 + threadIdx.x] = powers[r * 4 + threadIdx.x];
  if (threadIdx.x == 0) {
    omega_out[b] = om;
    alpha_out[b] = alpha[r];
    lab[b] = labels[r];
  }
}

}  // namespace

extern "C" {

int ds_assemble_threads() { return ds::kAssembleThreads; }

// RPNN layout: grids [n, layers * 225] uint8, omega and labels [n], idx [b]
// int64 → z [b, layers, 226], lab [b].
int ds_assemble_disney(const void* grids, const float* omega, const float* labels, int64_t n,
                       const int64_t* idx, int b, int layers, float* z, float* lab,
                       void* stream) {
  if (b <= 0) return 0;
  const size_t smem = (size_t)stage_words(layers * ds::kAssembleLayer) * sizeof(uint4);
  assemble_disney_kernel<<<b, ds::kAssembleThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)grids, omega, labels, n, idx, layers, z, lab);
  return (int)cudaGetLastError();
}

// Baked layout: probes [n, 4 * probe_layers * 225] uint8 (a row's four
// corners together), rt [n, rt_layers * 225] uint8, powers [n, 4], omega,
// alpha, labels [n], idx [b] int64 → probe_out [b, 4, probe_layers, 225],
// rt_out [b, rt_layers, 226], powers_out [b, 4], omega_out, alpha_out,
// lab [b].
int ds_assemble_baked(const void* probes, const void* rt, const float* powers,
                      const float* omega, const float* alpha, const float* labels, int64_t n,
                      const int64_t* idx, int b, int probe_layers, int rt_layers,
                      float* probe_out, float* rt_out, float* powers_out, float* omega_out,
                      float* alpha_out, float* lab, void* stream) {
  if (b <= 0) return 0;
  const int words = stage_words(4 * probe_layers * ds::kAssembleLayer) +
                    stage_words(rt_layers * ds::kAssembleLayer);
  const size_t smem = (size_t)words * sizeof(uint4);
  assemble_baked_kernel<<<b, ds::kAssembleThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)probes, (const uint8_t*)rt, powers, omega, alpha, labels, n, idx,
      probe_layers, rt_layers, probe_out, rt_out, powers_out, omega_out, alpha_out, lab);
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif  // DS_HOST_EMULATION
