// K2: the RPNN descriptor stencil, one thread per (point, stencil column)
// that walks the column's layers.
//
// Replaces the XLA gather program of deepestscatter_tpu/ops/descriptor.py::
// gather_descriptor (lines 92-141) over ops/grid.py::sample_mip and the
// packed trilinear path (lines 149-238), followed by omega_angle and
// with_angle: the output is the [M, L, 226] tensor DisneyModel consumes.
//
// Any number of layers up to kMaxLayers: 10 for the RPNN, 3 for the baked
// renderer's realtime stencil, 9 for the probe bake, whose light frame is
// built from the fixed probe direction instead of the view (gather_
// descriptor's frame_dir).
//
// Element (row, layer, col): col 225 is omega = acos(clip(light . view));
// col < 225 is the stencil sample (x, y, z) = (col % 5, col / 5 % 5,
// col / 25) - 2 in the light frame eZ = -light, eX = norm(eZ x f),
// eY = eX x eZ of the row's frame direction f (the view unless the caller
// gives another), spaced scale_l = 0.5 / dm * 2^l, sampled linear-mip-linear
// at the layer's static LOD (levels and lerp weights computed on the host,
// as the JAX package does with Python floats), faded to 0 over one mip
// voxel outside the box.  The mip voxel uses the unclamped 2^max(mip, 0)
// while the LOD is clamped to the pyramid, as in the JAX package.
// descriptor_element below states this for one element; the kernel
// computes the same values a column at a time.
//
// Bound on the card: 103 operations a stencil sample and 56 a second mip
// level (the offset, one trilinear, the fade), 0.2663 ms for the frame's
// 53,655 points; the 485 MB output needs 0.145 ms at the HBM rate and the
// pyramid (19 MB uint8 at 256^3) stays in L2.
//
// What held the first design back (one thread per output element; 2.861 ms
// on an H100 at 700 W for 121.3 M elements, 10.7x the bound): it was
// issue-bound on work it repeated, ~500 instructions an element (~60 G in
// all, ~2 ms at the card's issue rate):
//   - four 64-bit divisions or remainders for (row, layer, col), each a
//     software routine;
//   - the point's light frame (two cross products, sqrtf, three IEEE
//     divisions) for each of the point's 2,260 elements;
//   - the column's unscaled stencil offset for each of its ten layers;
//   - four IEEE divisions (three by bbox, one by the mip voxel), although
//     on the RPNN scene every divisor but the voxel is a power of two;
//   - trilinear taps with int64 index math, twice on the layers that lerp
//     two mip levels.
// The design here (descriptor_column):
//   1. A thread per (point, column), (point, col) from the flat index with
//      32-bit divisions by the constant 226 (a multiply and a shift); the
//      offset digits the same way.  The wrapper raises where M x 226 or the
//      pyramid reach 2^31, so nothing is 64-bit but the output offset.
//   2. The light frame once a thread (point_frame): a tenth of its cost
//      before.  Staging it in shared memory for the block's (at most three)
//      points is the alternative probes/march_variants.py times.
//   3. The unscaled offset once a column; each layer then scales it with
//      the expression of descriptor_element, so every value keeps its bits.
//   4. A (column, layer): three coordinates by div_exact (products by the
//      exact reciprocal where bbox is a power of two), 32-bit trilinear
//      taps (trilinear_strided) on one or two levels, the fade with the
//      voxel's exact reciprocal where it is a power of two and an IEEE
//      division where not, the fade's box corner precomputed on the host,
//      one store.  At a fixed layer consecutive threads store consecutive
//      columns.
//   5. Omega once a point, stored into each layer.
// Measured (probes/march_variants.py, the frame's 53,655 points, H100 at
// 700 W): 1.66 ms against 2.76 for a thread per element; staging the frame
// in shared memory 1.65 (within the runs' spread, so the simpler per-thread
// frame stays).
#include "common.cuh"

namespace ds {

constexpr int kMaxLayers = 16;
constexpr int kMaxLevels = 24;
constexpr int kRowWidth = 226;  // 225 stencil samples + omega

struct DescConsts {
  float bbox[3];
  float inv_bbox[3];  // pow2_recip(bbox)
  float half_box[3];  // bbox * 0.5
  int n_layers;
  int lo[kMaxLayers];
  int hi[kMaxLayers];
  int use_hi[kMaxLayers];
  float w_lo[kMaxLayers];
  float w_hi[kMaxLayers];
  float scale[kMaxLayers];
  float voxel[kMaxLayers];
  float inv_voxel[kMaxLayers];  // pow2_recip(voxel)
  float half_voxel[kMaxLayers];
  float corner[kMaxLayers][3];  // max(bbox * 0.5 - half_voxel, 0)
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
    const float* __restrict__ dirs, const float* __restrict__ frames,
    const float* __restrict__ ez, const float* __restrict__ light, const DescConsts& c) {
  const int col = (int)(gid % kRowWidth);
  const int64_t rl = gid / kRowWidth;
  const int layer = (int)(rl % c.n_layers);
  const int64_t row = rl / c.n_layers;
  if (col == kRowWidth - 1) {
    const float vx = dirs[3 * row], vy = dirs[3 * row + 1], vz = dirs[3 * row + 2];
    const float d = (light[0] * vx + light[1] * vy) + light[2] * vz;
    return acosf(fminf(fmaxf(d, -1.0f), 1.0f));
  }
  // Light frame of the frame direction: eX = norm(eZ x f), eY = eX x eZ.
  const float vx = frames[3 * row], vy = frames[3 * row + 1], vz = frames[3 * row + 2];
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

// Level `level` of the pyramid at (ux, uy, uz) with 32-bit taps.
template <typename T>
__device__ __forceinline__ float column_sample(const T* __restrict__ mips, const DescConsts& c,
                                               int level, float ux, float uy, float uz) {
  return trilinear_strided(mips + c.level_off[level], c.level_n[level][0],
                           c.level_n[level][1], c.level_n[level][2], ux, uy, uz);
}

// Column `col` of point p, every layer: out[p, l, col] = descriptor_element
// of that element, bitwise.  F is point_frame of p's frame direction.
template <typename T>
__device__ __forceinline__ void descriptor_column(
    int p, int col, const T* __restrict__ mips, const float* __restrict__ pos,
    const float* __restrict__ dirs, const float* __restrict__ light, const DescConsts& c,
    const PointFrame& F, float* __restrict__ out) {
  float* o = out + (int64_t)p * (c.n_layers * kRowWidth) + col;
  if (col == kRowWidth - 1) {
    const float omega = omega_angle(light, dirs[3 * p], dirs[3 * p + 1], dirs[3 * p + 2]);
    for (int l = 0; l < c.n_layers; ++l) o[l * kRowWidth] = omega;
    return;
  }
  const int q = col / 5;
  const float ox = (float)(col - 5 * q - 2);
  const float oy = (float)(q % 5 - 2);
  const float oz = (float)(col / 25 - 2);
  const float offx = (F.xx * ox + F.yx * oy) + F.zx * oz;
  const float offy = (F.xy * ox + F.yy * oy) + F.zy * oz;
  const float offz = (F.xz * ox + F.yz * oy) + F.zz * oz;
  const float p0 = pos[3 * p], p1 = pos[3 * p + 1], p2 = pos[3 * p + 2];
  for (int l = 0; l < c.n_layers; ++l) {
    const float sc = c.scale[l];
    const float px = p0 + offx * sc;
    const float py = p1 + offy * sc;
    const float pz = p2 + offz * sc;
    const float ux = div_exact(px, c.bbox[0], c.inv_bbox[0]);
    const float uy = div_exact(py, c.bbox[1], c.inv_bbox[1]);
    const float uz = div_exact(pz, c.bbox[2], c.inv_bbox[2]);
    const int lo = c.lo[l];
    float density = column_sample(mips, c, lo, ux, uy, uz);
    if (c.use_hi[l]) {
      const float hi_val = column_sample(mips, c, c.hi[l], ux, uy, uz);
      density = density * c.w_lo[l] + hi_val * c.w_hi[l];
    }
    const float e0 = fmaxf(fabsf(px - c.half_box[0]) - c.corner[l][0], 0.0f);
    const float e1 = fmaxf(fabsf(py - c.half_box[1]) - c.corner[l][1], 0.0f);
    const float e2 = fmaxf(fabsf(pz - c.half_box[2]) - c.corner[l][2], 0.0f);
    const float dist = sqrtf((e0 * e0 + e1 * e1) + e2 * e2);
    const float t = fminf(fmaxf(div_exact(dist, c.voxel[l], c.inv_voxel[l]), 0.0f), 1.0f);
    o[l * kRowWidth] = density * (1.0f - t);
  }
}

// Host constants: f = bbox[3] + (w_lo, w_hi, scale, voxel, half_voxel) per
// layer; i = (lo, hi, use_hi) per layer + (offset, nx, ny, nz) per level.
inline DescConsts desc_consts(const float* f, const int64_t* i, int n_layers,
                              int n_levels) {
  DescConsts c;
  for (int k = 0; k < 3; ++k) {
    c.bbox[k] = f[k];
    c.inv_bbox[k] = pow2_recip(f[k]);
    c.half_box[k] = f[k] * 0.5f;
  }
  c.n_layers = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    c.w_lo[l] = f[3 + 5 * l];
    c.w_hi[l] = f[3 + 5 * l + 1];
    c.scale[l] = f[3 + 5 * l + 2];
    c.voxel[l] = f[3 + 5 * l + 3];
    c.inv_voxel[l] = pow2_recip(c.voxel[l]);
    c.half_voxel[l] = f[3 + 5 * l + 4];
    for (int k = 0; k < 3; ++k) {
      const float corner = c.half_box[k] - c.half_voxel[l];
      c.corner[l][k] = corner > 0.0f ? corner : 0.0f;  // fmaxf(corner, 0)
    }
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

// The launch's limits: the layer and level tables, and 32-bit flat thread
// and texel indices.
inline bool desc_args_ok(int64_t m, int n_layers, int n_levels) {
  return n_layers >= 1 && n_layers <= kMaxLayers && n_levels >= 1 &&
         n_levels <= kMaxLevels && m * kRowWidth < ((int64_t)1 << 31);
}

}  // namespace ds

#ifndef DS_HOST_EMULATION

constexpr int kDescThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kDescThreads) descriptor_kernel(
    const T* __restrict__ mips, const float* __restrict__ pos,
    const float* __restrict__ dirs, const float* __restrict__ frames,
    const float* __restrict__ ez, const float* __restrict__ light, int total,
    ds::DescConsts c, float* __restrict__ out) {
  const int gid = blockIdx.x * kDescThreads + threadIdx.x;
  if (gid >= total) return;
  const int p = gid / ds::kRowWidth;
  const int col = gid - p * ds::kRowWidth;
  const ds::PointFrame F =
      ds::point_frame(ez, frames[3 * p], frames[3 * p + 1], frames[3 * p + 2]);
  ds::descriptor_column(p, col, mips, pos, dirs, light, c, F, out);
}

// Fills out[m, n_layers, 226]: the stencil in the light frame of
// frames[m, 3] (the view directions dirs[m, 3] for the RPNN and the
// realtime BNN stencil, the fixed probe direction for the probe bake),
// omega from dirs.  fconsts: bbox[3] + 5 floats per layer (w_lo, w_hi,
// scale, voxel, half_voxel); iconsts: 3 ints per layer (lo, hi, use_hi) + 4
// per level (offset, nx, ny, nz).  1 <= n_layers <= 16; m x 226 and the
// pyramid's texels must stay below 2^31.
extern "C" int ds_descriptor(const void* mips, int is_u8, const float* pos,
                             const float* dirs, const float* frames, const float* ez,
                             const float* light, int64_t m, int n_layers, int n_levels,
                             const float* fconsts, const int64_t* iconsts, float* out,
                             void* stream) {
  if (!ds::desc_args_ok(m, n_layers, n_levels)) return (int)cudaErrorInvalidValue;
  if (m <= 0) return 0;
  const ds::DescConsts c = ds::desc_consts(fconsts, iconsts, n_layers, n_levels);
  const int total = (int)(m * ds::kRowWidth);
  const unsigned blocks = (unsigned)((total + kDescThreads - 1) / kDescThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_u8) {
    descriptor_kernel<uint8_t><<<blocks, kDescThreads, 0, s>>>(
        (const uint8_t*)mips, pos, dirs, frames, ez, light, total, c, out);
  } else {
    descriptor_kernel<float><<<blocks, kDescThreads, 0, s>>>(
        (const float*)mips, pos, dirs, frames, ez, light, total, c, out);
  }
  return (int)cudaGetLastError();
}

#endif  // DS_HOST_EMULATION
