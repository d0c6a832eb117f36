// K3: the in-scatter (sun transmittance) bake, a block per x-row of voxels
// with the row's shared arithmetic done once and its taps in shared memory.
//
// Replaces the XLA loop of deepestscatter_tpu/render/inscatter.py::
// _bake_chunk (lines 35-71), which marches every voxel of a chunk in
// lockstep under a global any() early-out.
//
// Per voxel (x, y, z): base = (x, y, z) / max_dim; step i samples at
// base + to_light * (step * i) (a product, never an accumulation), then
// T *= exp(-sigma * step).  With early-out the voxel stops once
// T * 255 < 1; in the JAX loop such a voxel is frozen by a mask while
// others go on, so stopping the voxel gives the same value.  The caller
// quantizes floor(T * 255) / 255 and builds the texture.  bake_voxel states
// this for one voxel; bake_row and the kernel compute the same values.
//
// Bound on the card: the operations of n_voxels x steps trilinear samples
// from a density texture that stays in L2 (its bytes take 0.006 ms at
// 256^3).  Of a sample's work, the y and z half is the same for every
// voxel of one x-row at one step: counted once a row, the bound is that
// of ~45 operations a voxel-step and ~45 a row-step.
//
// What held the first design back (one thread per voxel; 61.05 ms at 256^3
// for 7.38 G steps on an H100 at 700 W, 7.9x its bound then counted at 70
// operations a voxel-step): it was close to issue-bound at ~190
// instructions a step (three IEEE divisions, three axis cells, eight
// int64-indexed byte loads each converted and scaled on its own, expf),
// and every voxel of a row repeated the row's y and z work.
// The design here: a block takes one x-row (y, z), or a segment of it where
// the row is longer than the block's kBakeThreads * V voxels; each thread
// carries V voxels (strided by the block size, so a warp's shared-memory
// taps are neighbours), V independent chains.
//   - Once a row and step (row_step): s = step * i; py, pz, uy, uz; the y
//     and z cells; the four wz * wy products; the four row offsets.
//   - The four texture rows (z0|z1) x (y0|y1) the taps read are staged in
//     shared memory as float32 (uint8 dequantized as texel() does, so a
//     tap is one shared load, one multiply, one add), with 16-byte loads
//     where the rows allow; restaged only when (y0, z0) changes, about
//     every other step at 256^3.  TMA is not used: a tensor map for four
//     rows of at most 2 KB costs more than it saves, and neither TMA nor
//     cp.async can dequantize on the way.
//   - Once a voxel and step (row_density): px, ux, the x cell and weights,
//     the eight taps, expf and the early-out test.  The block leaves the
//     march when __syncthreads_or finds no live voxel.
//   - Texture coordinates divide by bbox as a product where bbox is a power
//     of two (common.cuh::div_exact), which keeps every value.
// Measured (probes/march_variants.py, 256^3, H100 at 700 W): V = 8 is the
// fastest of 1, 2, 4 and 8; time falls with V as the row's work is shared
// by more voxels.  At 256^3, V = 8 makes a block one warp.
#include "common.cuh"

namespace ds {

// Voxels a thread carries.
constexpr int kBakeVoxels = 8;

struct BakeConsts {
  float bbox[3];
  float light[3];  // light_dir; the march goes along -light_dir
  float step;
  float dm;
  float max_dim;
  float inv_bbox[3];  // pow2_recip(bbox): texture coordinates as products
};

// One voxel's march, one step at a time.
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

// What the voxels of row (y, z) share at step i: the four texture rows the
// taps read (offsets, index iz * 2 + iy), their (wz * wy) weights, lx * s,
// and the key z0 * ny + y0 the rows change with.
struct RowStep {
  int off[4];
  float wzy[4];
  float lxs;
  int key;
};

__device__ __forceinline__ RowStep row_step(const BakeConsts& c, float by, float bz, int i,
                                            int nx, int ny, int nz) {
  const float s = c.step * (float)i;
  const float ly = -c.light[1], lz = -c.light[2];
  const float py = by + ly * s, pz = bz + lz * s;
  const float uy = div_exact(py, c.bbox[1], c.inv_bbox[1]),
              uz = div_exact(pz, c.bbox[2], c.inv_bbox[2]);
  const AxisCell cy = axis_cell(uy * (float)ny - 0.5f, ny);
  const AxisCell cz = axis_cell(uz * (float)nz - 0.5f, nz);
  const float wy[2] = {1.0f - cy.frac, cy.frac};
  const float wz[2] = {1.0f - cz.frac, cz.frac};
  const int ys[2] = {cy.i0, cy.i1};
  const int zs[2] = {cz.i0, cz.i1};
  RowStep r;
  for (int q = 0; q < 4; ++q) {
    const int iy = q & 1, iz = q >> 1;
    r.wzy[q] = wz[iz] * wy[iy];
    r.off[q] = (zs[iz] * ny + ys[iy]) * nx;
  }
  r.lxs = (-c.light[0]) * s;
  r.key = cz.i0 * ny + cy.i0;
  return r;
}

// Density at the voxel of base bx, from the four rows staged in rows[4 * nx]
// (trilinear's taps, weights and sum order).
__device__ __forceinline__ float row_density(const float* rows, int nx, const RowStep& r,
                                             float bx, const BakeConsts& c) {
  const float px = bx + r.lxs;
  const float ux = div_exact(px, c.bbox[0], c.inv_bbox[0]);
  const AxisCell cx = axis_cell(ux * (float)nx - 0.5f, nx);
  const float wx[2] = {1.0f - cx.frac, cx.frac};
  const int xs[2] = {cx.i0, cx.i1};
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ix = k & 1, q = k >> 1;
    const float term = rows[q * nx + xs[ix]] * (r.wzy[q] * wx[ix]);
    acc = k == 0 ? term : acc + term;
  }
  return acc * c.dm;
}

// Copies elements first, first + stride, ... of each of r's four texture
// rows into rows[4 * nx], dequantized.  (The unrolled q keeps r in
// registers.)
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ dens, int nx,
                                           const RowStep& r, float* rows, int first,
                                           int stride) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    for (int x = first; x < nx; x += stride) rows[q * nx + x] = texel(dens, r.off[q] + x);
  }
}

__device__ __forceinline__ bool bake_live(float trans, int early_out) {
  return !early_out || trans * 255.0f >= 1.0f;
}

// Row (y, z) into out_row[nx], with the row's shared arithmetic once a step:
// the formulation the kernel runs with a block of threads.  rows is
// scratch of 4 * nx floats.
template <typename T>
__device__ __forceinline__ void bake_row(int y, int z, const T* __restrict__ dens, int nx,
                                         int ny, int nz, const BakeConsts& c, int n_steps,
                                         int early_out, float* rows, float* out_row) {
  const float by = (float)y / c.max_dim, bz = (float)z / c.max_dim;
  for (int x = 0; x < nx; ++x) out_row[x] = 1.0f;
  int key = -1;
  for (int i = 0; i < n_steps; ++i) {
    bool any = false;
    for (int x = 0; x < nx; ++x) any = any || bake_live(out_row[x], early_out);
    if (!any) break;
    const RowStep r = row_step(c, by, bz, i, nx, ny, nz);
    if (r.key != key) {
      stage_rows(dens, nx, r, rows, 0, 1);
      key = r.key;
    }
    for (int x = 0; x < nx; ++x) {
      if (!bake_live(out_row[x], early_out)) continue;
      const float density = row_density(rows, nx, r, (float)x / c.max_dim, c);
      out_row[x] = out_row[x] * expf(-density * c.step);
    }
  }
}

inline BakeConsts bake_consts(const float* k) {
  BakeConsts c;
  for (int i = 0; i < 3; ++i) {
    c.bbox[i] = k[i];
    c.inv_bbox[i] = pow2_recip(k[i]);
    c.light[i] = k[3 + i];
  }
  c.step = k[6];
  c.dm = k[7];
  c.max_dim = k[8];
  return c;
}

}  // namespace ds

#ifndef DS_HOST_EMULATION

constexpr int kBakeThreads = 128;  // the most threads a block

// 16-byte staging of the four rows (nx a multiple of 16 for uint8, of 4 for
// float32, and a 16-byte aligned texture); the same values as stage_rows.
__device__ __forceinline__ void stage_rows_vec(const uint8_t* __restrict__ dens, int nx,
                                               const ds::RowStep& r, float* rows) {
  const int chunks = nx / 16;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    for (int j = threadIdx.x; j < chunks; j += blockDim.x) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(dens + r.off[q]) + j);
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
      float4* dst = reinterpret_cast<float4*>(rows + q * nx + 16 * j);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        dst[m] = make_float4((float)(w[m] & 0xffu) * ds::kU8Scale,
                             (float)((w[m] >> 8) & 0xffu) * ds::kU8Scale,
                             (float)((w[m] >> 16) & 0xffu) * ds::kU8Scale,
                             (float)(w[m] >> 24) * ds::kU8Scale);
      }
    }
  }
}

__device__ __forceinline__ void stage_rows_vec(const float* __restrict__ dens, int nx,
                                               const ds::RowStep& r, float* rows) {
  const int chunks = nx / 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    for (int j = threadIdx.x; j < chunks; j += blockDim.x) {
      reinterpret_cast<float4*>(rows + q * nx)[j] =
          __ldg(reinterpret_cast<const float4*>(dens + r.off[q]) + j);
    }
  }
}

// Block (row = y + ny * (z - z_begin), segment): thread t carries the
// voxels x = segment * blockDim.x * V + t + j * blockDim.x, j < V.  The
// launch covers the planes z_begin .. z_begin + gridDim.x / ny - 1 and
// writes them from out[0] on.
template <typename T, int V>
__global__ void __launch_bounds__(kBakeThreads) bake_rows_kernel(
    const T* __restrict__ dens, int nx, int ny, int nz, ds::BakeConsts c, int n_steps,
    int early_out, int vec, int z_begin, float* __restrict__ out) {
  extern __shared__ __align__(16) float rows[];
  const int row = blockIdx.x;
  const int y = row % ny, z = z_begin + row / ny;
  const int x0 = blockIdx.y * blockDim.x * V + threadIdx.x;
  const float by = (float)y / c.max_dim, bz = (float)z / c.max_dim;
  float bx[V], trans[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    bx[j] = (float)(x0 + j * (int)blockDim.x) / c.max_dim;
    trans[j] = 1.0f;
  }
  int key = -1;
  for (int i = 0; i < n_steps; ++i) {
    unsigned live = 0u;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (x0 + j * (int)blockDim.x < nx && ds::bake_live(trans[j], early_out)) live |= 1u << j;
    }
    // Also the barrier before the rows are restaged.
    if (!__syncthreads_or(live != 0u)) break;
    const ds::RowStep r = ds::row_step(c, by, bz, i, nx, ny, nz);
    if (r.key != key) {  // the same for the whole block
      if (vec) {
        stage_rows_vec(dens, nx, r, rows);
      } else {
        ds::stage_rows(dens, nx, r, rows, threadIdx.x, blockDim.x);
      }
      __syncthreads();
      key = r.key;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (live & (1u << j)) {
        trans[j] = trans[j] * expf(-ds::row_density(rows, nx, r, bx[j], c) * c.step);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int x = x0 + j * (int)blockDim.x;
    if (x < nx) out[(int64_t)row * nx + x] = trans[j];
  }
}

template <int V, typename T>
static int launch_rows(const T* dens, int nx, int ny, int nz, const ds::BakeConsts& c,
                       int n_steps, int early_out, int z_begin, int z_end, float* out,
                       cudaStream_t s) {
  const int per_thread = (nx + V - 1) / V;
  int threads = (per_thread + 31) / 32 * 32;
  if (threads > kBakeThreads) threads = kBakeThreads;
  const dim3 grid((unsigned)(ny * (z_end - z_begin)),
                  (unsigned)((nx + threads * V - 1) / (threads * V)));
  const size_t smem = 4 * (size_t)nx * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bake_rows_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int lanes = sizeof(T) == 1 ? 16 : 4;
  const int vec = nx % lanes == 0 && reinterpret_cast<uintptr_t>(dens) % 16 == 0;
  bake_rows_kernel<T, V><<<grid, threads, smem, s>>>(dens, nx, ny, nz, c, n_steps,
                                                     early_out, vec, z_begin, out);
  return (int)cudaGetLastError();
}

// The row kernel with V voxels a thread (ds_bake's arguments) over the
// planes [z_begin, z_end) (z_end -1: to the last plane).
template <int V>
static int bake_rows(const void* dens, int is_u8, int nx, int ny, int nz,
                     const float* consts, int n_steps, int early_out, float* out,
                     void* stream, int z_begin = 0, int z_end = -1) {
  if (z_end < 0) z_end = nz;
  if (z_begin < 0 || z_end > nz || z_begin > z_end) return (int)cudaErrorInvalidValue;
  if ((int64_t)nx * ny * (z_end - z_begin) <= 0) return 0;
  const ds::BakeConsts c = ds::bake_consts(consts);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_u8) {
    return launch_rows<V, uint8_t>((const uint8_t*)dens, nx, ny, nz, c, n_steps, early_out,
                                   z_begin, z_end, out, s);
  }
  return launch_rows<V, float>((const float*)dens, nx, ny, nz, c, n_steps, early_out,
                               z_begin, z_end, out, s);
}

// Bakes every voxel into out[nz * ny * nx] (z-major).  consts: bbox[3],
// light_dir[3], step, dm, max_dim (9 host floats).  The caller guarantees
// nx * ny * nz < 2^31 and 16 * nx bytes of shared memory a block.
extern "C" int ds_bake(const void* dens, int is_u8, int nx, int ny, int nz,
                       const float* consts, int n_steps, int early_out, float* out,
                       void* stream) {
  return bake_rows<ds::kBakeVoxels>(dens, is_u8, nx, ny, nz, consts, n_steps, early_out,
                                    out, stream);
}

// ds_bake over the planes [z_begin, z_end) of the grid only, into
// out[(z_end - z_begin) * ny * nx] (a rank's share of the sharded bake,
// parallel/spatial.py): the same values as those planes of ds_bake.
extern "C" int ds_bake_planes(const void* dens, int is_u8, int nx, int ny, int nz,
                              const float* consts, int n_steps, int early_out, int z_begin,
                              int z_end, float* out, void* stream) {
  return bake_rows<ds::kBakeVoxels>(dens, is_u8, nx, ny, nz, consts, n_steps, early_out,
                                    out, stream, z_begin, z_end);
}

#endif  // DS_HOST_EMULATION
