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

// trilinear() with 32-bit index math: the cell's base offset once, the
// eight taps at the constant strides 1, nx and nx * ny (0 where the +1
// corner is clamped).  The same taps, weights and sum order, so the same
// value; the caller guarantees nx * ny * nz < 2^31.
template <typename T>
__device__ __forceinline__ float trilinear_strided(const T* __restrict__ g, int nx, int ny,
                                                   int nz, float ux, float uy, float uz) {
  const AxisCell cx = axis_cell(ux * (float)nx - 0.5f, nx);
  const AxisCell cy = axis_cell(uy * (float)ny - 0.5f, ny);
  const AxisCell cz = axis_cell(uz * (float)nz - 0.5f, nz);
  const float wx[2] = {1.0f - cx.frac, cx.frac};
  const float wy[2] = {1.0f - cy.frac, cy.frac};
  const float wz[2] = {1.0f - cz.frac, cz.frac};
  const int base = (cz.i0 * ny + cy.i0) * nx + cx.i0;
  const int sx = cx.i1 - cx.i0, sy = (cy.i1 - cy.i0) * nx, sz = (cz.i1 - cz.i0) * (nx * ny);
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
