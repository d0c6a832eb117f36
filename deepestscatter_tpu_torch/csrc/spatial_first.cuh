// K9's first design (csrc/spatial.cu): a thread a ray, each marching its
// ray step by step until it parks, ends or uses up the phase's steps.  It
// is the per-ray statement of what the package's kernel computes; csrc/
// spatial_variants.cu builds it as a kernel to time it against the
// package's, and tests/torch_kernel_host.cpp runs it on the CPU.  Include
// after spatial.cu.
#pragma once

namespace ds {
namespace spatial {

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
