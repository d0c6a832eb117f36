// Trilinear taps and their adjoints, shared by the differentiable
// renderer's kernels: K8a and K8b (csrc/diff.cu) and K8c
// (csrc/path_adjoint.cu).  taps_at gives a sample's eight texels and
// weights in common.cuh::trilinear's order (so taps_value equals
// trilinear bitwise), with the slopes of the cell fractions; add_to is the
// adjoints' scatter into a gradient grid.
#pragma once

#include "common.cuh"

namespace ds {
namespace diff {

// *p += v: an atomicAdd on the card, a plain add in the host build.  A
// zero adds nothing and is skipped.
template <typename G>
__device__ __forceinline__ void add_to(G* p, float v) {
  if (v == 0.0f) return;
#ifdef DS_HOST_EMULATION
  *p += (G)v;
#else
  atomicAdd(p, (G)v);
#endif
}

// The grid scatters of the march's adjoint go through an Add (add(p, v):
// *p += v); the package's is add_to.  csrc/diff_variants.cu aims them
// elsewhere, so that probes/march_variants.py splits the adjoint's time.
struct AddTo {
  template <typename G>
  __device__ __forceinline__ void operator()(G* p, float v) const {
    add_to(p, v);
  }
};

struct Grid3 {
  int nx, ny, nz;
  float bbox[3];
  float inv_bbox[3];  // pow2_recip(bbox): coordinates as products
};

inline Grid3 grid3(int nx, int ny, int nz, const float* bbox) {
  Grid3 g;
  g.nx = nx;
  g.ny = ny;
  g.nz = nz;
  for (int i = 0; i < 3; ++i) {
    g.bbox[i] = bbox[i];
    g.inv_bbox[i] = pow2_recip(bbox[i]);
  }
  return g;
}

// The eight taps of a trilinear sample (common.cuh::trilinear's cells,
// weights (wz * wy) * wx and corner order), with the slopes of the three
// fractions in u: n where floor(t) >= 0, else 0 (the fraction is pinned to
// 0 there).
struct Taps {
  int idx[8];
  float w[8];
  float wx[2], wy[2], wz[2];
  float sx, sy, sz;
};

__device__ __forceinline__ Taps taps_at(const Grid3& g, float ux, float uy, float uz) {
  const float tx = ux * (float)g.nx - 0.5f;
  const float ty = uy * (float)g.ny - 0.5f;
  const float tz = uz * (float)g.nz - 0.5f;
  const AxisCell cx = axis_cell(tx, g.nx);
  const AxisCell cy = axis_cell(ty, g.ny);
  const AxisCell cz = axis_cell(tz, g.nz);
  Taps t;
  t.wx[0] = 1.0f - cx.frac;
  t.wx[1] = cx.frac;
  t.wy[0] = 1.0f - cy.frac;
  t.wy[1] = cy.frac;
  t.wz[0] = 1.0f - cz.frac;
  t.wz[1] = cz.frac;
  t.sx = floorf(tx) < 0.0f ? 0.0f : (float)g.nx;
  t.sy = floorf(ty) < 0.0f ? 0.0f : (float)g.ny;
  t.sz = floorf(tz) < 0.0f ? 0.0f : (float)g.nz;
  const int xs[2] = {cx.i0, cx.i1};
  const int ys[2] = {cy.i0, cy.i1};
  const int zs[2] = {cz.i0, cz.i1};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ix = k & 1, iy = (k >> 1) & 1, iz = k >> 2;
    t.idx[k] = (zs[iz] * g.ny + ys[iy]) * g.nx + xs[ix];
    t.w[k] = (t.wz[iz] * t.wy[iy]) * t.wx[ix];
  }
  return t;
}

__device__ __forceinline__ float taps_value(const float* __restrict__ grid, const Taps& t) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float term = grid[t.idx[k]] * t.w[k];
    acc = k == 0 ? term : acc + term;
  }
  return acc;
}

// d sample / d u along x, y and z.
__device__ __forceinline__ void taps_slope(const float* __restrict__ grid, const Taps& t,
                                           float* du) {
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ix = k & 1, iy = (k >> 1) & 1, iz = k >> 2;
    const float v = grid[t.idx[k]];
    const float ax = v * (t.wz[iz] * t.wy[iy]);
    const float ay = v * (t.wz[iz] * t.wx[ix]);
    const float az = v * (t.wy[iy] * t.wx[ix]);
    gx = ix ? gx + ax : gx - ax;
    gy = iy ? gy + ay : gy - ay;
    gz = iz ? gz + az : gz - az;
  }
  du[0] = gx * t.sx;
  du[1] = gy * t.sy;
  du[2] = gz * t.sz;
}

// d (s * sample) / d p into dp.
__device__ __forceinline__ void taps_point_slope(const float* __restrict__ grid, const Grid3& g,
                                                 const Taps& t, float s, float* dp) {
  float du[3];
  taps_slope(grid, t, du);
#pragma unroll
  for (int a = 0; a < 3; ++a) dp[a] = div_exact(s * du[a], g.bbox[a], g.inv_bbox[a]);
}

// Adds s * w_k to the eight texels, and returns d (s * sample) / d p.
template <typename G, class Add>
__device__ __forceinline__ void taps_adjoint(const float* __restrict__ grid, const Grid3& g,
                                             const Taps& t, float s, G* d_grid, float* dp,
                                             const Add& add) {
#pragma unroll
  for (int k = 0; k < 8; ++k) add(d_grid + t.idx[k], s * t.w[k]);
  taps_point_slope(grid, g, t, s, dp);
}

__device__ __forceinline__ void unit_coords(const Grid3& g, const float* p, float* u) {
#pragma unroll
  for (int a = 0; a < 3; ++a) u[a] = div_exact(p[a], g.bbox[a], g.inv_bbox[a]);
}

// diff.py::sample_density's mask: u in [0, 1] on every axis.
__device__ __forceinline__ bool inside_unit(const float* u) {
  return u[0] >= 0.0f && u[0] <= 1.0f && u[1] >= 0.0f && u[1] <= 1.0f && u[2] >= 0.0f &&
         u[2] <= 1.0f;
}

}  // namespace diff
}  // namespace ds
