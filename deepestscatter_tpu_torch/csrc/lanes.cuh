// The lanes of a group working on one item together: the group masks and
// the segmented scan that merges their grid scatters (group_deposit), shared
// by K8b's adjoint (csrc/diff.cu) and K8c's sweep (csrc/path_adjoint.cu).
// group_bits and lowest_lane are host-compilable (the host build emulates
// a group's lanes one after the other); the rest needs the card's
// shuffles and ballots.
#pragma once

#include "common.cuh"

namespace ds {
namespace diff {

__device__ __forceinline__ unsigned group_bits(int n) {
  return n >= 32 ? 0xffffffffu : (1u << n) - 1u;
}

__device__ __forceinline__ int lowest_lane(unsigned bits) {
#ifdef DS_HOST_EMULATION
  return __builtin_ctz(bits);
#else
  return __ffs(bits) - 1;
#endif
}

}  // namespace diff
}  // namespace ds

#ifndef DS_HOST_EMULATION

// Sums the eight values v[8] of the lanes of a group over each run of
// consecutive lanes with equal keys (the first texel of a step's cell, a
// ray's steps in one cell being consecutive; negative where the lane
// scatters nothing), by a segmented scan over the group; the last lane of
// each run adds the sums to the eight texels idx[8] of the float32 or
// float64 grid through add (a zero adds nothing).
template <int G, typename T, class Add>
__device__ __forceinline__ void group_deposit(unsigned gmask, int gl, int shift, int key,
                                              const int* idx, float* v, T* grid,
                                              const Add& add) {
  // Runs numbered by their first lanes: equal numbers are consecutive.
  const int below = __shfl_up_sync(gmask, key, 1, G);
  const unsigned heads = __ballot_sync(gmask, gl == 0 || below != key) >> shift;
  const int run = __popc(heads & ds::diff::group_bits(gl + 1));
#pragma unroll
  for (int o = 1; o < G; o <<= 1) {
    const int ro = __shfl_up_sync(gmask, run, o, G);
    const bool take = gl >= o && ro == run;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float x = __shfl_up_sync(gmask, v[k], o, G);
      if (take) v[k] = v[k] + x;
    }
  }
  if (key >= 0 && (gl == G - 1 || ((heads >> (gl + 1)) & 1u))) {
#pragma unroll
    for (int k = 0; k < 8; ++k) add(grid + idx[k], v[k]);
  }
}

// The lane setup of a group of G lanes: the lane's index in its group, the
// group's first lane in the warp and its mask.
struct GroupLanes {
  int gl, shift;
  unsigned mask;
};

template <int G>
__device__ __forceinline__ GroupLanes group_lanes() {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G: a power of two up to 32");
  GroupLanes L;
  const int lane = threadIdx.x & 31;
  L.gl = lane & (G - 1);
  L.shift = lane - L.gl;
  L.mask = ds::diff::group_bits(G) << L.shift;
  return L;
}

// v[3] summed over the group (a shuffle tree), on lane 0.
template <int G, typename T>
__device__ __forceinline__ void group_sum3(const GroupLanes& gr, T* v) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) v[a] += __shfl_down_sync(gr.mask, v[a], o, G);
  }
}

#endif  // DS_HOST_EMULATION
