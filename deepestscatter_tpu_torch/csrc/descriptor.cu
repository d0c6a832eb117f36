// K2: the RPNN descriptor stencil, one thread per output element.
//
// Replaces the XLA gather program of deepestscatter_tpu/ops/descriptor.py::
// gather_descriptor (lines 92-141) over ops/grid.py::sample_mip and the
// packed trilinear path (lines 149-238), followed by omega_angle and
// with_angle: the output is the [M, L, 226] tensor DisneyModel consumes.
//
// Element (row, layer, col): col 225 is omega = acos(clip(light . view));
// col < 225 is the stencil sample (x, y, z) = (col % 5, col / 5 % 5,
// col / 25) - 2 in the light frame eZ = -light, eX = norm(eZ x view),
// eY = eX x eZ, spaced scale_l = 0.5 / dm * 2^l, sampled linear-mip-linear
// at the layer's static LOD (levels and lerp weights computed on the host,
// as the JAX package does with Python floats), faded to 0 over one mip
// voxel outside the box.  The mip voxel uses the unclamped 2^max(mip, 0)
// while the LOD is clamped to the pyramid, as in the JAX package.
//
// Bound on the card: the output (M x 2260 float32, ~0.5 GB at the
// operating point) is written once, and each sample is one or two
// trilinear gathers from a pyramid that stays in L2 (19 MB uint8 at
// 256^3); bytes written and the per-sample arithmetic are of the same
// order.  Design of this first version: one thread per output element, so
// neighbouring threads write neighbouring addresses (coalesced stores) and
// gather neighbouring stencil taps (shared cache lines); each thread
// recomputes its row's light frame (~30 operations) instead of staging it.
#include "common.cuh"

namespace ds {

constexpr int kMaxLayers = 16;
constexpr int kMaxLevels = 24;
constexpr int kRowWidth = 226;  // 225 stencil samples + omega

struct DescConsts {
  float bbox[3];
  int n_layers;
  int lo[kMaxLayers];
  int hi[kMaxLayers];
  int use_hi[kMaxLayers];
  float w_lo[kMaxLayers];
  float w_hi[kMaxLayers];
  float scale[kMaxLayers];
  float voxel[kMaxLayers];
  float half_voxel[kMaxLayers];
  int64_t level_off[kMaxLevels];
  int level_n[kMaxLevels][3];  // (nx, ny, nz)
};

template <typename T>
__device__ __forceinline__ float level_sample(const T* __restrict__ mips,
                                              const DescConsts& c, int level, float ux,
                                              float uy, float uz) {
  return trilinear(mips + c.level_off[level], c.level_n[level][0], c.level_n[level][1],
                   c.level_n[level][2], ux, uy, uz);
}

template <typename T>
__device__ __forceinline__ float descriptor_element(
    int64_t gid, const T* __restrict__ mips, const float* __restrict__ pos,
    const float* __restrict__ dirs, const float* __restrict__ ez,
    const float* __restrict__ light, const DescConsts& c) {
  const int col = (int)(gid % kRowWidth);
  const int64_t rl = gid / kRowWidth;
  const int layer = (int)(rl % c.n_layers);
  const int64_t row = rl / c.n_layers;
  const float vx = dirs[3 * row], vy = dirs[3 * row + 1], vz = dirs[3 * row + 2];
  if (col == kRowWidth - 1) {
    const float d = (light[0] * vx + light[1] * vy) + light[2] * vz;
    return acosf(fminf(fmaxf(d, -1.0f), 1.0f));
  }
  // Light frame: eX = norm(eZ x view), eY = eX x eZ.
  const float zx = ez[0], zy = ez[1], zz = ez[2];
  float xx = zy * vz - zz * vy;
  float xy = zz * vx - zx * vz;
  float xz = zx * vy - zy * vx;
  const float xn = fmaxf(sqrtf((xx * xx + xy * xy) + xz * xz), 1e-12f);
  xx = xx / xn;
  xy = xy / xn;
  xz = xz / xn;
  const float yx = xy * zz - xz * zy;
  const float yy = xz * zx - xx * zz;
  const float yz = xx * zy - xy * zx;

  const float ox = (float)(col % 5 - 2);
  const float oy = (float)((col / 5) % 5 - 2);
  const float oz = (float)(col / 25 - 2);
  const float sc = c.scale[layer];
  const float px = pos[3 * row] + ((xx * ox + yx * oy) + zx * oz) * sc;
  const float py = pos[3 * row + 1] + ((xy * ox + yy * oy) + zy * oz) * sc;
  const float pz = pos[3 * row + 2] + ((xz * ox + yz * oy) + zz * oz) * sc;
  const float ux = px / c.bbox[0], uy = py / c.bbox[1], uz = pz / c.bbox[2];

  float density = level_sample(mips, c, c.lo[layer], ux, uy, uz);
  if (c.use_hi[layer]) {
    const float hi_val = level_sample(mips, c, c.hi[layer], ux, uy, uz);
    density = density * c.w_lo[layer] + hi_val * c.w_hi[layer];
  }
  // Fade to zero outside the box shrunk by half a mip voxel.
  const float hb0 = c.bbox[0] * 0.5f, hb1 = c.bbox[1] * 0.5f, hb2 = c.bbox[2] * 0.5f;
  const float hv = c.half_voxel[layer];
  const float e0 = fmaxf(fabsf(px - hb0) - fmaxf(hb0 - hv, 0.0f), 0.0f);
  const float e1 = fmaxf(fabsf(py - hb1) - fmaxf(hb1 - hv, 0.0f), 0.0f);
  const float e2 = fmaxf(fabsf(pz - hb2) - fmaxf(hb2 - hv, 0.0f), 0.0f);
  const float dist = sqrtf((e0 * e0 + e1 * e1) + e2 * e2);
  const float t = fminf(fmaxf(dist / c.voxel[layer], 0.0f), 1.0f);
  return density * (1.0f - t);
}

// Host constants: f = bbox[3] + (w_lo, w_hi, scale, voxel, half_voxel) per
// layer; i = (lo, hi, use_hi) per layer + (offset, nx, ny, nz) per level.
inline DescConsts desc_consts(const float* f, const int64_t* i, int n_layers,
                              int n_levels) {
  DescConsts c;
  for (int k = 0; k < 3; ++k) c.bbox[k] = f[k];
  c.n_layers = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    c.w_lo[l] = f[3 + 5 * l];
    c.w_hi[l] = f[3 + 5 * l + 1];
    c.scale[l] = f[3 + 5 * l + 2];
    c.voxel[l] = f[3 + 5 * l + 3];
    c.half_voxel[l] = f[3 + 5 * l + 4];
    c.lo[l] = (int)i[3 * l];
    c.hi[l] = (int)i[3 * l + 1];
    c.use_hi[l] = (int)i[3 * l + 2];
  }
  for (int v = 0; v < n_levels; ++v) {
    c.level_off[v] = i[3 * n_layers + 4 * v];
    c.level_n[v][0] = (int)i[3 * n_layers + 4 * v + 1];
    c.level_n[v][1] = (int)i[3 * n_layers + 4 * v + 2];
    c.level_n[v][2] = (int)i[3 * n_layers + 4 * v + 3];
  }
  return c;
}

}  // namespace ds

#ifndef DS_HOST_EMULATION

template <typename T>
__global__ void __launch_bounds__(256) descriptor_kernel(
    const T* __restrict__ mips, const float* __restrict__ pos,
    const float* __restrict__ dirs, const float* __restrict__ ez,
    const float* __restrict__ light, int64_t total, ds::DescConsts c,
    float* __restrict__ out) {
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= total) return;
  out[gid] = ds::descriptor_element(gid, mips, pos, dirs, ez, light, c);
}

// Fills out[m, n_layers, 226].  fconsts: bbox[3] + 5 floats per layer
// (w_lo, w_hi, scale, voxel, half_voxel); iconsts: 3 ints per layer
// (lo, hi, use_hi) + 4 per level (offset, nx, ny, nz).
extern "C" int ds_descriptor(const void* mips, int is_u8, const float* pos,
                             const float* dirs, const float* ez, const float* light,
                             int64_t m, int n_layers, int n_levels,
                             const float* fconsts, const int64_t* iconsts, float* out,
                             void* stream) {
  if (n_layers < 1 || n_layers > ds::kMaxLayers || n_levels < 1 ||
      n_levels > ds::kMaxLevels)
    return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  const ds::DescConsts c = ds::desc_consts(fconsts, iconsts, n_layers, n_levels);
  const int64_t total = m * n_layers * ds::kRowWidth;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_u8) {
    descriptor_kernel<uint8_t><<<blocks, threads, 0, s>>>(
        (const uint8_t*)mips, pos, dirs, ez, light, total, c, out);
  } else {
    descriptor_kernel<float><<<blocks, threads, 0, s>>>(
        (const float*)mips, pos, dirs, ez, light, total, c, out);
  }
  return (int)cudaGetLastError();
}

#endif  // DS_HOST_EMULATION
