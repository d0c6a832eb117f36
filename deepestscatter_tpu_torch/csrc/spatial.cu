// K9: one phase of the path tracer's march on one rank's z-slab of the
// grid (the spatially sharded renderer, parallel/spatial_render.py).
//
// Replaces the XLA loop of deepestscatter_tpu/parallel/spatial_render.py::
// make_spatial_subframe: march_step (lines 351-425) scanned
// steps_per_phase times in phase_body (lines 447-466), for the cell-grid
// scene (the brick branch, lines 249-349, is a TPU gather layout the port
// never took).
//
// A rank holds planes [z0 - halo, z0 + slab + halo) of the density and
// in-scatter grids (clamped to the grid's ends); it owns the planes
// [z0, z0 + slab).  Every rank holds every ray's state (a record of
// kWidth floats).  A launch marches, for each ray alive at the phase's
// start, at most `steps` steps: a step is taken only where its sample
// cell's z index (the trilinear's lower z corner in the whole grid) is
// owned, else the ray parks for the rest of the phase.  A ray whose first
// step is owned is "touched"; exactly one rank touches each alive ray, and
// the host merges the ranks' records by a masked sum over the space group
// (the owner's record wins), then launches the next phase.
//
// The step, the scatter with its NEE, the next flight and the roulette are
// K4's own device functions (pathtrace.cuh: begin_sample, free_step,
// scatter, new_direction), so a ray's decisions and values are K4's bit
// for bit.  The only change is the z index of a texture tap: a plane of
// the whole grid is read from the slab at plane - (z0 - halo), clamped
// into the slab (SlabZ).  A sample cell in the owned planes has its +1 z
// corner at most one plane above, in the halo (or clamped at the grid's
// top as the whole grid clamps it); the scatter point's NEE read lands at
// most one step behind the sample, inside the one-plane halo where the
// step is at most a cell.  A ray whose record has depth 0 is fresh: the
// launch begins its sample (begin_sample: the first direction redrawn in
// SUN_MULTIPLE_SCATTER, od at counter 4, or 0 in single scatter) before
// its ownership test, as every rank does, so its first step is tested
// along the direction K4 marches.
//
// Bound on the card: operations, as K4's (~80 a step, ~270 an in-box
// scatter); a slab's textures stay in L2.  A thread a ray; the phase's
// rays are independent.  Design: the first, simple form (K4's item queue
// would also serve); a phase's threads wait for the ray of the warp with
// the most steps in the phase.
#include "pathtrace.cuh"

namespace ds {
namespace spatial {

// A ray's record: position, direction, transmittance, od, weight,
// radiance, depth (0 = not begun), alive, touched (this phase, by this
// rank), steps (marched this phase).
enum : int {
  kPos = 0,
  kDir = 3,
  kTrans = 6,
  kOd = 7,
  kWeight = 8,
  kRad = 9,
  kDepth = 12,
  kAlive = 13,
  kTouched = 14,
  kSteps = 15,
  kWidth = 16
};

// Plane iz of the whole grid in a slab holding planes [off, off + last],
// clamped into it.
struct SlabZ {
  int off;   // z0 - halo
  int last;  // slab + 2 * halo - 1
  __device__ __forceinline__ int operator()(int iz) const {
    const int l = iz - off;
    return l < 0 ? 0 : (l > last ? last : l);
  }
};

// Ray r's phase: its record from rec_in to rec_out.
template <typename T>
__device__ __forceinline__ void phase_ray(int64_t r, const T* __restrict__ dens,
                                          const T* __restrict__ insc, int nx, int ny, int nz,
                                          int z0, int slab, SlabZ zm,
                                          const float* __restrict__ eval_rows,
                                          const float* __restrict__ inv, const PtConsts& c,
                                          uint32_t seed, const int64_t* __restrict__ ids,
                                          int steps, const float* __restrict__ rec_in,
                                          float* __restrict__ rec_out) {
  float rec[kWidth];
  for (int k = 0; k < kWidth; ++k) rec[k] = rec_in[r * kWidth + k];
  rec[kTouched] = 0.0f;
  rec[kSteps] = 0.0f;
  if (rec[kAlive] != 0.0f) {
    Sample S;
    const uint32_t id = (uint32_t)ids[r];
    if (rec[kDepth] == 0.0f) {
      begin_sample(S, c, inv, seed, id, rec[kPos], rec[kPos + 1], rec[kPos + 2], rec[kDir],
                   rec[kDir + 1], rec[kDir + 2]);
    } else {
      S.px = rec[kPos];
      S.py = rec[kPos + 1];
      S.pz = rec[kPos + 2];
      S.dx = rec[kDir];
      S.dy = rec[kDir + 1];
      S.dz = rec[kDir + 2];
      S.trans = rec[kTrans];
      S.od = rec[kOd];
      S.weight = rec[kWeight];
      for (int i = 0; i < 3; ++i) S.rad[i] = rec[kRad + i];
      S.seed = seed;
      S.id = id;
      S.depth = (int)rec[kDepth];
      S.steps = 0;
      S.bounces = 0;
    }
    bool alive = true;
    for (int k = 0; k < steps; ++k) {
      const float ax = S.px + S.dx * c.step, ay = S.py + S.dy * c.step,
                  az = S.pz + S.dz * c.step;
      const float ux = div_exact(ax, c.bbox[0], c.inv_bbox[0]);
      const float uy = div_exact(ay, c.bbox[1], c.inv_bbox[1]);
      const float uz = div_exact(az, c.bbox[2], c.inv_bbox[2]);
      const int cz = axis_cell(uz * (float)nz - 0.5f, nz).i0;
      if (cz < z0 || cz >= z0 + slab) break;  // parks: another rank's cell
      const float density = trilinear_strided(dens, nx, ny, nz, ux, uy, uz, zm) * c.dm;
      const float tn = S.trans * expf(-density * c.step);
      ++S.steps;
      if (!(S.od > tn)) {
        if (free_step(S, c, ax, ay, az, tn)) {
          alive = false;
          break;
        }
        continue;
      }
      if (scatter(S, insc, nx, ny, nz, eval_rows, inv, c, ax, ay, az, density, tn, zm)) {
        alive = false;
        break;
      }
    }
    // Only the owner writes: an untouched record stays as it was (a fresh
    // ray stays fresh), and the owner's wins the merge.
    if (S.steps > 0) {
      rec[kPos] = S.px;
      rec[kPos + 1] = S.py;
      rec[kPos + 2] = S.pz;
      rec[kDir] = S.dx;
      rec[kDir + 1] = S.dy;
      rec[kDir + 2] = S.dz;
      rec[kTrans] = S.trans;
      rec[kOd] = S.od;
      rec[kWeight] = S.weight;
      for (int i = 0; i < 3; ++i) rec[kRad + i] = S.rad[i];
      rec[kDepth] = (float)S.depth;
      rec[kAlive] = alive ? 1.0f : 0.0f;
      rec[kTouched] = 1.0f;
      rec[kSteps] = (float)S.steps;
    }
  }
  for (int k = 0; k < kWidth; ++k) rec_out[r * kWidth + k] = rec[k];
}

}  // namespace spatial
}  // namespace ds

#ifndef DS_HOST_EMULATION

constexpr int kSpatialThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kSpatialThreads) spatial_phase_kernel(
    const T* __restrict__ dens, const T* __restrict__ insc, int nx, int ny, int nz, int z0,
    int slab, ds::spatial::SlabZ zm, const float* __restrict__ eval_rows,
    const float* __restrict__ inv, ds::PtConsts c, uint32_t seed,
    const int64_t* __restrict__ ids, int64_t n, int steps, const float* __restrict__ rec_in,
    float* __restrict__ rec_out) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  ds::spatial::phase_ray(r, dens, insc, nx, ny, nz, z0, slab, zm, eval_rows, inv, c, seed,
                         ids, steps, rec_in, rec_out);
}

// One phase over n rays.  dens, insc: the rank's slab [slab + 2 halo, ny,
// nx] of the [nz, ny, nx] grids (uint8 where is_u8, else float32); consts
// and ground as ds_pathtrace's; seed: the subframe's seed; rec_in /
// rec_out: [n, 16] records (not aliased).
extern "C" int ds_spatial_phase(const void* dens, const void* insc, int is_u8, int nx,
                                int ny, int nz, int z0, int slab, int halo,
                                const float* eval_rows, int n_phase, const float* inv_rows,
                                int n_inv, const float* consts, const float* ground,
                                int max_depth, int rr_start, int flags, uint32_t seed,
                                const int64_t* ids, int64_t n, int steps,
                                const float* rec_in, float* rec_out, void* stream) {
  if (n <= 0) return 0;
  const ds::PtConsts c =
      ds::pt_consts(consts, ground, 0, max_depth, rr_start, n_phase, n_inv, flags);
  const ds::spatial::SlabZ zm{z0 - halo, slab + 2 * halo - 1};
  const unsigned blocks = (unsigned)((n + kSpatialThreads - 1) / kSpatialThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_u8) {
    spatial_phase_kernel<uint8_t><<<blocks, kSpatialThreads, 0, s>>>(
        (const uint8_t*)dens, (const uint8_t*)insc, nx, ny, nz, z0, slab, zm, eval_rows,
        inv_rows, c, seed, ids, n, steps, rec_in, rec_out);
  } else {
    spatial_phase_kernel<float><<<blocks, kSpatialThreads, 0, s>>>(
        (const float*)dens, (const float*)insc, nx, ny, nz, z0, slab, zm, eval_rows,
        inv_rows, c, seed, ids, n, steps, rec_in, rec_out);
  }
  return (int)cudaGetLastError();
}

// The registers a thread of K9 on uint8 textures takes, or -1.
extern "C" int ds_spatial_registers() {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, spatial_phase_kernel<uint8_t>) != cudaSuccess) return -1;
  return a.numRegs;
}

#endif  // DS_HOST_EMULATION
