// K3: the in-scatter (sun transmittance) bake, one thread per voxel.
//
// Replaces the XLA loop of deepestscatter_tpu/render/inscatter.py::
// _bake_chunk (lines 35-71), which marches every voxel of a chunk in
// lockstep under a global any() early-out.
//
// Per voxel (x, y, z): base = (x, y, z) / max_dim; step i samples at
// base + to_light * (step * i) (a product, never an accumulation), then
// T *= exp(-sigma * step).  With early-out the voxel stops once
// T * 255 < 1; in the JAX loop such a voxel is frozen by a mask while
// others go on, so stopping the thread gives the same value.  The caller
// quantizes floor(T * 255) / 255 and builds the texture.
//
// Bound on the card: n_voxels x steps trilinear samples (~60 operations
// each) from a density texture that stays in L2; the operation count is
// the roofline bound.  Design of this first version: one thread per voxel
// in x-fastest order, so a warp marches 32 neighbouring parallel rays whose
// gathers share cache lines; a thread exits as soon as its voxel freezes.
#include "common.cuh"

namespace ds {

struct BakeConsts {
  float bbox[3];
  float light[3];  // light_dir; the march goes along -light_dir
  float step;
  float dm;
  float max_dim;
  float pad_;
};

template <typename T>
__device__ __forceinline__ float bake_voxel(int64_t v, const T* __restrict__ dens, int nx,
                                            int ny, int nz, const BakeConsts& c,
                                            int n_steps, int early_out) {
  const int x = (int)(v % nx);
  const int y = (int)((v / nx) % ny);
  const int z = (int)(v / ((int64_t)nx * ny));
  const float bx = (float)x / c.max_dim, by = (float)y / c.max_dim,
              bz = (float)z / c.max_dim;
  const float lx = -c.light[0], ly = -c.light[1], lz = -c.light[2];
  float trans = 1.0f;
  for (int i = 0; i < n_steps; ++i) {
    if (early_out && !(trans * 255.0f >= 1.0f)) break;
    const float s = c.step * (float)i;
    const float px = bx + lx * s, py = by + ly * s, pz = bz + lz * s;
    const float density =
        trilinear(dens, nx, ny, nz, px / c.bbox[0], py / c.bbox[1], pz / c.bbox[2]) * c.dm;
    trans = trans * expf(-density * c.step);
  }
  return trans;
}

inline BakeConsts bake_consts(const float* k) {
  BakeConsts c;
  for (int i = 0; i < 3; ++i) {
    c.bbox[i] = k[i];
    c.light[i] = k[3 + i];
  }
  c.step = k[6];
  c.dm = k[7];
  c.max_dim = k[8];
  c.pad_ = 0.0f;
  return c;
}

}  // namespace ds

#ifndef DS_HOST_EMULATION

template <typename T>
__global__ void __launch_bounds__(256) bake_kernel(const T* __restrict__ dens, int nx,
                                                   int ny, int nz, int64_t n,
                                                   ds::BakeConsts c, int n_steps,
                                                   int early_out, float* __restrict__ out) {
  const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  out[v] = ds::bake_voxel(v, dens, nx, ny, nz, c, n_steps, early_out);
}

// Bakes every voxel into out[nz * ny * nx] (z-major).  consts: bbox[3],
// light_dir[3], step, dm, max_dim (9 host floats).
extern "C" int ds_bake(const void* dens, int is_u8, int nx, int ny, int nz,
                       const float* consts, int n_steps, int early_out, float* out,
                       void* stream) {
  const int64_t n = (int64_t)nx * ny * nz;
  if (n <= 0) return 0;
  const ds::BakeConsts c = ds::bake_consts(consts);
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_u8) {
    bake_kernel<uint8_t><<<blocks, threads, 0, s>>>((const uint8_t*)dens, nx, ny, nz, n,
                                                    c, n_steps, early_out, out);
  } else {
    bake_kernel<float><<<blocks, threads, 0, s>>>((const float*)dens, nx, ny, nz, n, c,
                                                  n_steps, early_out, out);
  }
  return (int)cudaGetLastError();
}

#endif  // DS_HOST_EMULATION
