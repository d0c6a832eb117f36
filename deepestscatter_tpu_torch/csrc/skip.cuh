// Empty-space skipping, the device side of ops/march.py's skips, shared by
// K4 and K7b (csrc/pathtrace.cuh), K1 (csrc/march.cu) and K7a
// (csrc/samples.cu).  Each kernel takes a skip as a template flag; the
// instantiation without one is the kernel as it was.
//
//   kSkipCell: after a march step into a cell whose 8 density corners are
//     all 0 (the trilinear density is then 0 across the closed cell), a
//     sample still in flight jumps empty_cell_exit_steps whole steps, to the
//     last lattice step before the cell's exit face; T is unchanged.  The
//     JAX package jumps after an iteration of up to march_substeps steps in
//     the fetched cell; a jump after every step lands on the same lattice
//     index, up to the ulp of the jump's product.
//   kSkipBlock: a step taken from a point whose dilated occupancy block
//     (ops/grid.py::build_occupancy) holds no density is sk.long_steps
//     lattice steps long, pos + dir * (step * long_steps); it samples the
//     density where it lands, as every step does.
//
// Float expressions follow ops/march.py (empty_cell_exit_steps, block_step,
// step_length) term by term; the build uses -fmad=false.
#pragma once

#include "common.cuh"

namespace ds {

enum : int { kSkipNone = 0, kSkipCell = 1, kSkipBlock = 2 };

// The jump's cap in whole steps (ops/march.py::empty_cell_exit_steps).
constexpr float kMaxJump = 64.0f;

// A launch's skip: the dilated occupancy [bz, by, bx] (float32, 1 where a
// block or a neighbour holds density), the block edge in cells, the long
// step's lattice steps, and where the kernel adds each pixel's lattice
// steps jumped (K4, K7b; null elsewhere).
struct SkipArgs {
  const float* occ;
  int bx, by, bz;
  int block;
  int long_steps;
  unsigned long long* jumped;
};

// The arguments the *_skip entry points take after those of the entry point
// they extend (ops/march.py::skip_args): the skip, the occupancy [bz, by,
// bx] and its (x, y, z) size, the block edge, the long step's lattice steps,
// and the lattice steps jumped a pixel (int64 [n], zeroed by the entry
// point, then added to by the kernel; null where not counted).
#define DS_SKIP_PARAMS                                                                     \
  int skip, const float *occ, int occ_x, int occ_y, int occ_z, int block, int long_steps, \
      unsigned long long *jumped
#define DS_SKIP_ARGS ds::SkipArgs{occ, occ_x, occ_y, occ_z, block, long_steps, jumped}

// The occupancy block along one axis: floor(t) clipped to [0, b - 1].
__device__ __forceinline__ int block_index(float t, int b) {
  int i = (int)fminf(fmaxf(floorf(t), -1.0f), (float)b);
  return i < 0 ? 0 : (i > b - 1 ? b - 1 : i);
}

// Whether the dilated block at normalized density coordinates (ux, uy, uz)
// of an [nz, ny, nx] grid is empty (occupancy < 0.5): block floor(u * dims
// / block).
__device__ __forceinline__ bool block_empty(const SkipArgs& sk, int nx, int ny, int nz,
                                            float ux, float uy, float uz) {
  const float b = (float)sk.block;
  const int ix = block_index((ux * (float)nx) / b, sk.bx);
  const int iy = block_index((uy * (float)ny) / b, sk.by);
  const int iz = block_index((uz * (float)nz) / b, sk.bz);
  return sk.occ[((int64_t)iz * sk.by + iy) * sk.bx + ix] < 0.5f;
}

// The lattice steps of the next step from normalized (ux, uy, uz), with
// `room` lattice steps left before the cap: min(long_steps, room), at least
// 1, where the block is empty; else 1.
__device__ __forceinline__ int block_steps(const SkipArgs& sk, int nx, int ny, int nz, float ux,
                                           float uy, float uz, int room) {
  if (!block_empty(sk, nx, ny, nz, ux, uy, uz)) return 1;
  const int m = sk.long_steps < room ? sk.long_steps : room;
  return m > 1 ? m : 1;
}

// The exit distance along one axis of the cell whose lower corner is c
// (a grid of n cells, box edge b): the cell spans (c + 0.5) / n * b to
// (c + 1.5) / n * b; an axis with |d| <= 1e-9 never exits.
__device__ __forceinline__ float axis_exit(int c, int n, float b, float p, float d) {
  const float cf = (float)c;
  const float lo = (cf + 0.5f) / (float)n * b;
  const float hi = ((cf + 1.0f) + 0.5f) / (float)n * b;
  const float bound = d > 0.0f ? hi : lo;
  return fabsf(d) > 1e-9f ? (bound - p) / d : INFINITY;
}

// ops/march.py::empty_cell_exit_steps for the point (px, py, pz) along
// (dx, dy, dz) in the packed cell at its normalized coordinates (ux, uy,
// uz): whole steps before the cell's exit face, at most kMaxJump and at
// most `room`.
__device__ __forceinline__ float cell_exit_steps(int nx, int ny, int nz, const float* bbox,
                                                 float step, float ux, float uy, float uz,
                                                 float px, float py, float pz, float dx,
                                                 float dy, float dz, int room) {
  const int cx = axis_cell(ux * (float)nx - 0.5f, nx).i0;
  const int cy = axis_cell(uy * (float)ny - 0.5f, ny).i0;
  const int cz = axis_cell(uz * (float)nz - 0.5f, nz).i0;
  const float tx = axis_exit(cx, nx, bbox[0], px, dx);
  const float ty = axis_exit(cy, ny, bbox[1], py, dy);
  const float t = fminf(fminf(tx, ty), axis_exit(cz, nz, bbox[2], pz, dz));
  const float e = fminf(floorf(fmaxf(t, 0.0f) / step), kMaxJump);
  return fminf(e, (float)room);
}

}  // namespace ds
