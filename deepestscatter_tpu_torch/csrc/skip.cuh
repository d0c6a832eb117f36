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
//     index, up to the ulp of the jump's product.  K4 and K7b compute the
//     exit from a table of the cell faces (FaceExit), K7a and the first
//     design by cell_exit_steps; both give the same value.
//   kSkipBlock: a step taken from a point whose dilated occupancy block
//     (ops/grid.py::build_occupancy) holds no density is sk.long_steps
//     lattice steps long, pos + dir * (step * long_steps); it samples the
//     density where it lands, as every step does.  K1 and K7a read the
//     float32 occupancy at every step (block_steps); K4 reads it as bits
//     (BitBlocks) and only where a sample holds no certificate
//     (pathtrace.cuh::march_steps_block): a step that lands in a cell with
//     a nonzero corner certifies that the next sk.sure_steps plain steps
//     leave occupied blocks, which the occupancy would confirm.
//
// Float expressions follow ops/march.py (empty_cell_exit_steps, block_step,
// step_length) term by term; the build uses -fmad=false.
#pragma once

#include "common.cuh"

namespace ds {

enum : int { kSkipNone = 0, kSkipCell = 1, kSkipBlock = 2, kSkipCellPow2 = 3 };

// The cell jump's instantiations of K4 and K7b: kSkipCell reads the cell
// faces from a face table, kSkipCellPow2 (a grid whose cell counts are all
// powers of two) takes them by product (FaceExit); the *_skip entry points
// choose one for the skip kSkipCell by the grid.
template <int Skip>
constexpr bool kCellJump = Skip == kSkipCell || Skip == kSkipCellPow2;

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
  // The cell jump of K4 and K7b (FaceExit; set by cell_recips): the exact
  // reciprocals of the grid's cells along x, y, z and of the step, 0 where
  // one is not a power of two.
  float inv_cells[3];
  float inv_step;
  // The block skip of K4 (BitBlocks, march_steps_block): the dilated
  // occupancy as bits (ops/grid.py::occupancy_bits) and the plain steps a
  // step into a cell with a nonzero corner certifies
  // (ops/march.py::block_sure_steps; 0: none).
  const uint32_t* bits;
  int sure_steps;
};

// sk with the cell jump's reciprocals of an [nz, ny, nx] grid at `step`.
inline SkipArgs cell_recips(SkipArgs sk, int nx, int ny, int nz, float step) {
  sk.inv_cells[0] = pow2_recip((float)nx);
  sk.inv_cells[1] = pow2_recip((float)ny);
  sk.inv_cells[2] = pow2_recip((float)nz);
  sk.inv_step = pow2_recip(step);
  return sk;
}

// The arguments the *_skip entry points take after those of the entry point
// they extend (ops/march.py::skip_args): the skip, the occupancy [bz, by,
// bx] and its (x, y, z) size, the block edge, the long step's lattice steps,
// the lattice steps jumped a pixel (int64 [n], zeroed by the entry point,
// then added to by the kernel; null where not counted), the occupancy's
// bits and the certified plain steps (K4's block skip).
#define DS_SKIP_PARAMS                                                                     \
  int skip, const float *occ, int occ_x, int occ_y, int occ_z, int block, int long_steps, \
      unsigned long long *jumped, const uint32_t *occ_bits, int sure_steps
#define DS_SKIP_ARGS                                                                        \
  ds::SkipArgs {                                                                            \
    occ, occ_x, occ_y, occ_z, block, long_steps, jumped, {0.0f, 0.0f, 0.0f}, 0.0f, occ_bits, \
        sure_steps                                                                          \
  }

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

// The occupancy as one bit a block, as K4's block skip reads it
// (pathtrace.cuh::march_steps_block): bit i & 31 of words[i >> 5] for
// block i = (iz * by + iy) * bx + ix, set where the dilated block is
// occupied (ops/grid.py::occupancy_bits); blocks of `block` cells, long
// steps of long_steps lattice steps.  steps() is block_steps' value at
// position (qx, qy, qz) of the box bbox (div_exact's recips inv), with
// `room` lattice steps left before the cap.
struct BitBlocks {
  const uint32_t* words;
  int bx, by, bz;
  int block;
  int long_steps;

  // The occupancy block of position q along one axis (box edge bbox, n
  // cells, nb blocks): block_empty's block_index((div_exact(q) * n) / b).
  __device__ __forceinline__ int axis(float q, float bbox, float recip, int n, int nb) const {
    return block_index((div_exact(q, bbox, recip) * (float)n) / (float)block, nb);
  }

  __device__ __forceinline__ int steps(int nx, int ny, int nz, const float* bbox,
                                       const float* inv, float qx, float qy, float qz,
                                       int room) const {
    const int i = (axis(qz, bbox[2], inv[2], nz, bz) * by + axis(qy, bbox[1], inv[1], ny, by)) *
                      bx +
                  axis(qx, bbox[0], inv[0], nx, bx);
    if ((words[i >> 5] >> (i & 31)) & 1u) return 1;
    const int m = long_steps < room ? long_steps : room;
    return m > 1 ? m : 1;
  }
};

// sk's occupancy bits (sk.bits) as BitBlocks.
__device__ __forceinline__ BitBlocks bit_blocks(const SkipArgs& sk) {
  return BitBlocks{sk.bits, sk.bx, sk.by, sk.bz, sk.block, sk.long_steps};
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

// The cell jump of K4 and K7b (pathtrace.cuh::march_steps_jump) takes the
// cell faces without dividing for them.  Face i of an axis of n cells at
// box edge b is face_position(i): axis_exit's lo of cell i and its hi of
// cell i - 1 ((float)(i - 1) + 1.0f is exact).  Where n is a power of two
// the face is ((float)i + 0.5f) * (1 / n) * b, the same value (div_exact's
// argument); else it is read from the launch's face table: the faces of x
// (nx + 1 of them), y (ny + 1) and z (nz + 1), face_table_entry.
__device__ __forceinline__ float face_position(int i, int n, float b) {
  return ((float)i + 0.5f) / (float)n * b;
}

// Entry i of the face table.
__device__ __forceinline__ float face_table_entry(int i, int nx, int ny, int nz,
                                                  const float* bbox) {
  if (i <= nx) return face_position(i, nx, bbox[0]);
  i -= nx + 1;
  if (i <= ny) return face_position(i, ny, bbox[1]);
  return face_position(i - (ny + 1), nz, bbox[2]);
}

#ifdef DS_HOST_EMULATION
inline
#else
__host__ __device__ __forceinline__
#endif
int face_table_size(int nx, int ny, int nz) {
  return nx + ny + nz + 3;
}

// The table's bytes a launch may hold in shared memory (the default limit
// of a block's dynamic shared memory).
constexpr int kMaxFaceTableBytes = 48 * 1024;

// Whether every cell count of an [nz, ny, nx] grid is a power of two (the
// cell jump's kSkipCellPow2).
inline bool pow2_cells(int nx, int ny, int nz) {
  return pow2_recip((float)nx) != 0.0f && pow2_recip((float)ny) != 0.0f &&
         pow2_recip((float)nz) != 0.0f;
}

// The cell jump's exit (cell_exit_steps' value): three divisions, where
// cell_exit_steps takes ten, the faces by product (Product: every cell
// count a power of two) or from the face table, and t / step as a product
// where the step is a power of two (div_exact).  The cell's lower corner
// (cx, cy, cz) is the one the step's taps found.
template <bool Product>
struct FaceExit {
  const float* table;  // the face table (unread where Product)
  int ty, tz;  // where y's and z's faces start in it
  float inv[3];  // SkipArgs::inv_cells
  float b[3];  // the box
  float inv_step;
  float step;

  __device__ __forceinline__ float face(int a, int i) const {
    if constexpr (Product) {
      return ((float)i + 0.5f) * inv[a] * b[a];
    } else {
      return table[(a == 0 ? 0 : (a == 1 ? ty : tz)) + i];
    }
  }

  // axis_exit's distance along axis a from cell c.
  __device__ __forceinline__ float axis(int a, int c, float p, float d) const {
    const float bound = face(a, d > 0.0f ? c + 1 : c);
    return fabsf(d) > 1e-9f ? (bound - p) / d : INFINITY;
  }

  __device__ __forceinline__ float operator()(int cx, int cy, int cz, float /*ux*/,
                                              float /*uy*/, float /*uz*/, float px, float py,
                                              float pz, float dx, float dy, float dz,
                                              int room) const {
    const float t = fminf(fminf(axis(0, cx, px, dx), axis(1, cy, py, dy)), axis(2, cz, pz, dz));
    const float e = fminf(floorf(div_exact(fmaxf(t, 0.0f), step, inv_step)), kMaxJump);
    return fminf(e, (float)room);
  }
};

// The exit of a launch on an [nz, ny, nx] grid with the box bbox and the
// step (sk's reciprocals; `table` the face table where !Product).
template <bool Product>
__device__ __forceinline__ FaceExit<Product> face_exit_of(const float* table, int nx, int ny,
                                                          const float* bbox, float step,
                                                          const SkipArgs& sk) {
  FaceExit<Product> F;
  F.table = table;
  F.ty = nx + 1;
  F.tz = nx + ny + 2;
  for (int a = 0; a < 3; ++a) {
    F.inv[a] = sk.inv_cells[a];
    F.b[a] = bbox[a];
  }
  F.inv_step = sk.inv_step;
  F.step = step;
  return F;
}

// The exit type of the cell jump's instantiation Skip.
template <int Skip>
using CellExit = FaceExit<Skip == kSkipCellPow2>;

// The same exit by cell_exit_steps (the first design's arithmetic), for
// csrc/pathtrace_variants.cu.
struct DividedExit {
  int nx, ny, nz;
  const float* bbox;
  float step;
  __device__ __forceinline__ float operator()(int /*cx*/, int /*cy*/, int /*cz*/, float ux,
                                              float uy, float uz, float px, float py, float pz,
                                              float dx, float dy, float dz, int room) const {
    return cell_exit_steps(nx, ny, nz, bbox, step, ux, uy, uz, px, py, pz, dx, dy, dz, room);
  }
};

}  // namespace ds
