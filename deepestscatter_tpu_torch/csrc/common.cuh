// Shared device helpers of the package's kernels: texel fetch with uint8
// dequantization, software trilinear sampling with the packed-corner clamp
// rule of the JAX package, and the PCG counter hash.
//
// Every float expression here is written in the order of the plain PyTorch
// versions (ops/grid.py, ops/rng.py).  The kernels are compiled with
// -fmad=false and without fast math, so no product is contracted into an
// FMA and expf/logf/sqrtf/acosf are the accurate library functions.
// Hardware tex3D is deliberately not used: its filter keeps 8 fractional
// bits of each weight.
#pragma once

#include <cmath>
#include <cstdint>
#ifndef DS_HOST_EMULATION
#include <cuda_runtime.h>
#endif

namespace ds {

// float32(1/255), the same rounding as numpy's float32(1.0 / 255.0).
constexpr float kU8Scale = (float)(1.0 / 255.0);

__device__ __forceinline__ float texel(const uint8_t* __restrict__ g, int64_t i) {
  return (float)g[i] * kU8Scale;
}

__device__ __forceinline__ float texel(const float* __restrict__ g, int64_t i) {
  return g[i];
}

// A texel's value from its stored word (texel's dequantization).
__device__ __forceinline__ float texel_value(uint8_t b) { return (float)b * kU8Scale; }
__device__ __forceinline__ float texel_value(float v) { return v; }

// 1 / b where b is a power of two, else 0 (host side, for div_exact).
inline float pow2_recip(float b) {
  int e;
  return std::frexp(b, &e) == 0.5f ? 1.0f / b : 0.0f;
}

// x / b, as a product where recip = pow2_recip(b) is not 0: dividing by a
// power of two and multiplying by its exact reciprocal round the same
// exact value once, so the two are equal bitwise.
__device__ __forceinline__ float div_exact(float x, float b, float recip) {
  return recip != 0.0f ? x * recip : x / b;
}

// Inside the box [0, b] with the JAX package's 0.01 margin.
__device__ __forceinline__ bool in_box(float x, float y, float z, const float* b) {
  return x >= -0.01f && x <= b[0] + 0.01f && y >= -0.01f && y <= b[1] + 0.01f &&
         z >= -0.01f && z <= b[2] + 0.01f;
}

struct AxisCell {
  int i0;
  int i1;
  float frac;
};

// Packed-path cell along one axis: frac = 0 where floor(t) < 0; cell
// clipped to [0, n-1]; the +1 corner clamped to n-1.
__device__ __forceinline__ AxisCell axis_cell(float t, int n) {
  const float t0 = floorf(t);
  AxisCell c;
  c.frac = t0 < 0.0f ? 0.0f : t - t0;
  int i = (int)fminf(fmaxf(t0, -1.0f), (float)n);
  i = i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
  c.i0 = i;
  c.i1 = i + 1 > n - 1 ? n - 1 : i + 1;
  return c;
}

// Trilinear sample of a [nz, ny, nx] grid at normalized (x, y, z): the eight
// corner weights (wz * wy) * wx, summed in corner order cx + 2 cy + 4 cz.
template <typename T>
__device__ __forceinline__ float trilinear(const T* __restrict__ g, int nx, int ny,
                                           int nz, float ux, float uy, float uz) {
  const AxisCell cx = axis_cell(ux * (float)nx - 0.5f, nx);
  const AxisCell cy = axis_cell(uy * (float)ny - 0.5f, ny);
  const AxisCell cz = axis_cell(uz * (float)nz - 0.5f, nz);
  const float wx[2] = {1.0f - cx.frac, cx.frac};
  const float wy[2] = {1.0f - cy.frac, cy.frac};
  const float wz[2] = {1.0f - cz.frac, cz.frac};
  const int xs[2] = {cx.i0, cx.i1};
  const int ys[2] = {cy.i0, cy.i1};
  const int zs[2] = {cz.i0, cz.i1};
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ix = k & 1, iy = (k >> 1) & 1, iz = k >> 2;
    const int64_t idx = ((int64_t)zs[iz] * ny + ys[iy]) * nx + xs[ix];
    const float term = texel(g, idx) * ((wz[iz] * wy[iy]) * wx[ix]);
    acc = k == 0 ? term : acc + term;
  }
  return acc;
}

// Where plane iz of a [nz, ny, nx] grid is stored: plane iz of the whole
// grid.
struct WholeZ {
  __device__ __forceinline__ int operator()(int iz) const { return iz; }
};

// trilinear() with 32-bit index math: the cell's base offset once, the
// eight taps at the constant strides 1, nx and nx * ny (0 where the +1
// corner is clamped).  The same taps, weights and sum order, so the same
// value; the caller guarantees nx * ny * nz < 2^31.  The cell is found in
// the whole [nz, ny, nx] grid; zmap gives the stored plane of its z
// corners (a slab of the grid, K9), so only the index moves.
template <typename T, typename Z = WholeZ>
__device__ __forceinline__ float trilinear_strided(const T* __restrict__ g, int nx, int ny,
                                                   int nz, float ux, float uy, float uz,
                                                   Z zmap = Z()) {
  const AxisCell cx = axis_cell(ux * (float)nx - 0.5f, nx);
  const AxisCell cy = axis_cell(uy * (float)ny - 0.5f, ny);
  const AxisCell cz = axis_cell(uz * (float)nz - 0.5f, nz);
  const float wx[2] = {1.0f - cx.frac, cx.frac};
  const float wy[2] = {1.0f - cy.frac, cy.frac};
  const float wz[2] = {1.0f - cz.frac, cz.frac};
  const int z0 = zmap(cz.i0);
  const int base = (z0 * ny + cy.i0) * nx + cx.i0;
  const int sx = cx.i1 - cx.i0, sy = (cy.i1 - cy.i0) * nx, sz = (zmap(cz.i1) - z0) * (nx * ny);
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ix = k & 1, iy = (k >> 1) & 1, iz = k >> 2;
    const int idx = base + (ix ? sx : 0) + (iy ? sy : 0) + (iz ? sz : 0);
    const float term = texel(g, idx) * ((wz[iz] * wy[iy]) * wx[ix]);
    acc = k == 0 ? term : acc + term;
  }
  return acc;
}

// trilinear_strided over the whole grid, and in cmax the largest of the
// eight texels (0 where every corner of the cell is 0: the empty-cell test
// of csrc/skip.cuh).  The same taps, weights and sum, so the same value.
template <typename T>
__device__ __forceinline__ float trilinear_strided_max(const T* __restrict__ g, int nx, int ny,
                                                       int nz, float ux, float uy, float uz,
                                                       float& cmax) {
  const AxisCell cx = axis_cell(ux * (float)nx - 0.5f, nx);
  const AxisCell cy = axis_cell(uy * (float)ny - 0.5f, ny);
  const AxisCell cz = axis_cell(uz * (float)nz - 0.5f, nz);
  const float wx[2] = {1.0f - cx.frac, cx.frac};
  const float wy[2] = {1.0f - cy.frac, cy.frac};
  const float wz[2] = {1.0f - cz.frac, cz.frac};
  const int base = (cz.i0 * ny + cy.i0) * nx + cx.i0;
  const int sx = cx.i1 - cx.i0, sy = (cy.i1 - cy.i0) * nx, sz = (cz.i1 - cz.i0) * (nx * ny);
  float acc = 0.0f;
  cmax = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ix = k & 1, iy = (k >> 1) & 1, iz = k >> 2;
    const float v = texel(g, base + (ix ? sx : 0) + (iy ? sy : 0) + (iz ? sz : 0));
    const float term = v * ((wz[iz] * wy[iy]) * wx[ix]);
    acc = k == 0 ? term : acc + term;
    cmax = k == 0 ? v : fmaxf(cmax, v);
  }
  return acc;
}

// trilinear_strided over the whole grid, with the cell's lower corner (x0,
// y0, z0) and whether its eight texels are all 0 (all at most 0 for
// float32; the bytes or'ed for uint8): trilinear_strided_max's test.  The
// same taps, weights and sum, so the same value.
template <typename T>
__device__ __forceinline__ float trilinear_cell(const T* __restrict__ g, int nx, int ny, int nz,
                                                float ux, float uy, float uz, int& x0, int& y0,
                                                int& z0, bool& empty) {
  const AxisCell cx = axis_cell(ux * (float)nx - 0.5f, nx);
  const AxisCell cy = axis_cell(uy * (float)ny - 0.5f, ny);
  const AxisCell cz = axis_cell(uz * (float)nz - 0.5f, nz);
  const float wx[2] = {1.0f - cx.frac, cx.frac};
  const float wy[2] = {1.0f - cy.frac, cy.frac};
  const float wz[2] = {1.0f - cz.frac, cz.frac};
  const int base = (cz.i0 * ny + cy.i0) * nx + cx.i0;
  const int sx = cx.i1 - cx.i0, sy = (cy.i1 - cy.i0) * nx, sz = (cz.i1 - cz.i0) * (nx * ny);
  float acc = 0.0f;
  T any = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ix = k & 1, iy = (k >> 1) & 1, iz = k >> 2;
    const T raw = g[base + (ix ? sx : 0) + (iy ? sy : 0) + (iz ? sz : 0)];
    const float v = texel_value(raw);
    const float term = v * ((wz[iz] * wy[iy]) * wx[ix]);
    acc = k == 0 ? term : acc + term;
    if constexpr (sizeof(T) == 1) {
      any = k == 0 ? raw : (T)(any | raw);
    } else {
      any = k == 0 ? raw : fmaxf(any, raw);
    }
  }
  x0 = cx.i0;
  y0 = cy.i0;
  z0 = cz.i0;
  empty = any <= (T)0;
  return acc;
}

// A light-oriented frame (eX, eY, eZ): eZ = -light / |light| (given),
// eX = norm(eZ x d) with the norm clamped to 1e-12, eY = eX x eZ, in the
// expression order of ops/descriptor.py::light_frame.
struct PointFrame {
  float xx, xy, xz;
  float yx, yy, yz;
  float zx, zy, zz;
};

__device__ __forceinline__ PointFrame point_frame(const float* __restrict__ ez, float vx,
                                                  float vy, float vz) {
  PointFrame F;
  F.zx = ez[0];
  F.zy = ez[1];
  F.zz = ez[2];
  float xx = F.zy * vz - F.zz * vy;
  float xy = F.zz * vx - F.zx * vz;
  float xz = F.zx * vy - F.zy * vx;
  const float xn = fmaxf(sqrtf((xx * xx + xy * xy) + xz * xz), 1e-12f);
  F.xx = xx / xn;
  F.xy = xy / xn;
  F.xz = xz / xn;
  F.yx = F.xy * F.zz - F.xz * F.zy;
  F.yy = F.xz * F.zx - F.xx * F.zz;
  F.yz = F.xx * F.zy - F.xy * F.zx;
  return F;
}

// acos(clip(light . v, -1, 1)): the angle omega between the light and a
// view direction (ops/descriptor.py::omega_angle).
__device__ __forceinline__ float omega_angle(const float* __restrict__ light, float vx,
                                             float vy, float vz) {
  const float d = (light[0] * vx + light[1] * vy) + light[2] * vz;
  return acosf(fminf(fmaxf(d, -1.0f), 1.0f));
}

// One PCG-RXS-M-XS output round (ops/rng.py::_pcg).
__device__ __forceinline__ uint32_t pcg(uint32_t x) {
  const uint32_t state = x * 747796405u + 2891336453u;
  const uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

__device__ __forceinline__ uint32_t hash_u32(uint32_t seed, uint32_t stream,
                                             uint32_t counter) {
  const uint32_t x = pcg(stream ^ (seed * 0x9E3779B9u));
  return pcg(x + counter * 0x85EBCA6Bu);
}

// Uniform float32 in [0, 1) with 24 bits (ops/rng.py::hash_uniform).
__device__ __forceinline__ float hash_uniform(uint32_t seed, uint32_t stream,
                                              uint32_t counter) {
  return (float)(hash_u32(seed, stream, counter) >> 8) * (float)(1.0 / 16777216.0);
}

}  // namespace ds
