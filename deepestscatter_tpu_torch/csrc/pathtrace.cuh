// K4's device functions: one sample of the path tracer's estimator as
// begin_sample, free_step and scatter (the step-by-step loop trace_sample,
// the lookahead march_steps / march_chunk), the per-pixel loop
// pathtrace_pixel, the work items and their records, and the fold.  The
// kernels of csrc/pathtrace.cu run them, and K8c (csrc/path_adjoint.cu)
// replays its paths with them, so both take the same decisions bit for bit.
#pragma once

#include "common.cuh"
#include "skip.cuh"

namespace ds {

// Steps of one lookahead chunk.
constexpr int kLookahead = 2;
// K7b: parked lanes of a warp at which it resolves their scatters.
constexpr int kParkAt = 20;
// K7b: the resident blocks a SM its launch bounds ask of the compiler.  1
// leaves nvcc free to take 79 registers (6 blocks a SM); the bound of
// threads alone, as K4 has it, held the kernel at 64.
constexpr int kRadianceBlocks = 1;

struct PtConsts {
  float bbox[3];
  float inv_bbox[3];  // pow2_recip(bbox): texture coordinates as products
  float step;
  float dm;  // density multiplier
  float light[3];  // light_dir (points from the sun)
  float radiance[3];
  float sun_ratio;
  float sun_cos_half;
  float rr_q;  // roulette survival probability
  float sky[3];
  float ground[3];
  int max_steps;  // per-sample step cap
  int max_depth;
  int rr_start;  // 0 = no roulette
  int n_phase;
  int n_inv;
  int flags;
};

enum : int { kSingle = 1, kResample = 2, kChopped1 = 4, kSky = 8 };


// float32(2 pi), as torch rounds the Python constant 2 * math.pi.
constexpr float kTwoPi = (float)(2.0 * 3.141592653589793);

// Lerp cell of t = u * n - 0.5 (ops/phase.py::_row_index).
__device__ __forceinline__ int row_index(float t, int n, float& frac) {
  const float t0 = floorf(t);
  frac = t0 < 0.0f ? 0.0f : t - t0;
  int i = (int)fminf(fmaxf(t0, -1.0f), (float)n);
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

__device__ __forceinline__ float cos_to_sun(const PtConsts& c, float dx, float dy,
                                            float dz) {
  return ((-c.light[0]) * dx + (-c.light[1]) * dy) + (-c.light[2]) * dz;
}

// render/pathtracer.py::new_direction: sample_cos_theta_fast,
// uniform_on_sphere_circle, from_onb (make_onb around d), normalize.
__device__ __forceinline__ void new_direction(const float* __restrict__ inv, int n_inv,
                                              float u_cdf, float u_phi, float& dx,
                                              float& dy, float& dz) {
  float frac;
  const int i0 = row_index(u_cdf * (float)n_inv - 0.5f, n_inv, frac);
  const float m = inv[2 * i0] * (1.0f - frac) + inv[2 * i0 + 1] * frac;
  const float ct = 2.0f * m - 1.0f;
  const float phi = u_phi * kTwoPi;
  const float st = sqrtf(fmaxf(1.0f - ct * ct, 0.0f));
  const float lx = st * cosf(phi), ly = st * sinf(phi), lz = ct;
  const float sign = dz >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + dz);
  const float b = (dx * dy) * a;
  const float tx = 1.0f + (sign * (dx * dx)) * a, ty = sign * b, tz = (-sign) * dx;
  const float bx = b, by = sign + (dy * dy) * a, bz = -dy;
  const float ox = (lx * tx + ly * bx) + lz * dx;
  const float oy = (lx * ty + ly * by) + lz * dy;
  const float oz = (lx * tz + ly * bz) + lz * dz;
  const float len = sqrtf((ox * ox + oy * oy) + oz * oz);
  dx = ox / len;
  dy = oy / len;
  dz = oz / len;
}

// Sky gradient, plus the sun disc at depth 1, times the path weight.
__device__ __forceinline__ void add_sky_exit(const PtConsts& c, float dx, float dy,
                                             float dz, int depth, float weight,
                                             float* rad) {
  const float t = fminf(fmaxf((dy + 0.5f) / 1.5f, 0.0f), 1.0f);
  const bool sun = depth == 1 && cos_to_sun(c, dx, dy, dz) > c.sun_cos_half;
  for (int i = 0; i < 3; ++i) {
    const float sky = c.ground[i] * (1.0f - t) + c.sky[i] * t;
    rad[i] = rad[i] + (sky + (sun ? c.radiance[i] : 0.0f)) * weight;
  }
}

// One sample in flight.
struct Sample {
  float px, py, pz;  // position (local coordinates)
  float dx, dy, dz;
  float trans, od, weight;
  float rad[3];
  uint32_t seed, id;
  int depth;
  int steps;  // march steps of this sample
  int bounces;  // its free flights that ended in the box
  // Lattice steps it advanced without a sample (a skip's jumps, and a long
  // step's steps but the one it samples): set only where a skip runs.
  int jumped;
};

// A sample from the box entry (ex, ey, ez) along (dx, dy, dz).
__device__ __forceinline__ void begin_sample(Sample& S, const PtConsts& c,
                                             const float* __restrict__ inv, uint32_t seed,
                                             uint32_t id, float ex, float ey, float ez,
                                             float dx, float dy, float dz) {
  S.px = ex;
  S.py = ey;
  S.pz = ez;
  S.dx = dx;
  S.dy = dy;
  S.dz = dz;
  for (int i = 0; i < 3; ++i) S.rad[i] = 0.0f;
  S.seed = seed;
  S.id = id;
  S.steps = 0;
  S.bounces = 0;
  if (c.flags & kResample) {
    new_direction(inv, c.n_inv, hash_uniform(seed, id, 0u), hash_uniform(seed, id, 1u),
                  S.dx, S.dy, S.dz);
  }
  S.depth = 1;
  S.weight = 1.0f;
  S.trans = 1.0f;
  S.od = hash_uniform(seed, id, (c.flags & kSingle) ? 0u : 4u);
}

// A march step to (ax, ay, az) whose transmittance tn stayed at or above
// od: moves there.  True where the sample ends (it left the box, or the
// oracle's depth test, which only bites at max_depth 1).
__device__ __forceinline__ bool free_step(Sample& S, const PtConsts& c, float ax, float ay,
                                          float az, float tn) {
  S.px = ax;
  S.py = ay;
  S.pz = az;
  S.trans = tn;
  if (!in_box(ax, ay, az, c.bbox)) {
    if (c.flags & kSky) add_sky_exit(c, S.dx, S.dy, S.dz, S.depth, S.weight, S.rad);
    return true;
  }
  return !(c.flags & kSingle) && S.depth >= c.max_depth;
}

// The pull-back from a crossing step to the scatter point,
// log(od / T) / sigma with the floors of ops/march.py::back_correct_distance.
__device__ __forceinline__ float back_distance(float od, float tn, float density) {
  return logf(fmaxf(od, 1e-20f) / fmaxf(tn, 1e-20f)) / fmaxf(density, 1e-10f);
}

// A march step to (ax, ay, az) of density `density` whose transmittance tn
// fell below od: the free flight ends there.  Adds NEE at an in-box
// scatter point and starts the next flight.  True where the sample ends.
// zmap: where the in-scatter grid stores a plane (common.cuh::WholeZ; K9's
// slab).
template <typename T, typename Z = WholeZ>
__device__ __forceinline__ bool scatter(Sample& S, const T* __restrict__ insc, int nx,
                                        int ny, int nz, const float* __restrict__ eval_rows,
                                        const float* __restrict__ inv, const PtConsts& c,
                                        float ax, float ay, float az, float density,
                                        float tn, Z zmap = Z()) {
  const bool single = c.flags & kSingle;
  const float back = back_distance(S.od, tn, density);
  const float sx = ax - S.dx * back, sy = ay - S.dy * back, sz = az - S.dz * back;
  const bool inb = in_box(sx, sy, sz, c.bbox);
  if (inb) {
    ++S.bounces;
    const bool chopped = S.depth != 1 || (c.flags & kChopped1);
    float frac;
    const float cosl = cos_to_sun(c, S.dx, S.dy, S.dz);
    const int i0 = row_index(((cosl + 1.0f) * 0.5f) * (float)c.n_phase - 0.5f,
                             c.n_phase, frac);
    const int col = chopped ? 2 : 0;
    const float p =
        eval_rows[4 * i0 + col] * (1.0f - frac) + eval_rows[4 * i0 + col + 1] * frac;
    const float sun_t = trilinear_strided(insc, nx, ny, nz,
                                          div_exact(sx, c.bbox[0], c.inv_bbox[0]),
                                          div_exact(sy, c.bbox[1], c.inv_bbox[1]),
                                          div_exact(sz, c.bbox[2], c.inv_bbox[2]), zmap);
    const float scale = (p * sun_t) * c.sun_ratio;
    for (int i = 0; i < 3; ++i) S.rad[i] = S.rad[i] + (c.radiance[i] * scale) * S.weight;
  }
  if (single) return true;
  const uint32_t ctr = (uint32_t)S.depth * 4u;
  const int new_depth = S.depth + 1;
  if (inb) {
    new_direction(inv, c.n_inv, hash_uniform(S.seed, S.id, ctr + 1u),
                  hash_uniform(S.seed, S.id, ctr + 2u), S.dx, S.dy, S.dz);
  }
  S.px = sx;
  S.py = sy;
  S.pz = sz;
  S.trans = 1.0f;
  S.od = hash_uniform(S.seed, S.id, (uint32_t)new_depth * 4u);
  bool end = new_depth >= c.max_depth;
  if (!inb) {
    if (c.flags & kSky) add_sky_exit(c, S.dx, S.dy, S.dz, S.depth, S.weight, S.rad);
    end = true;
  }
  if (c.rr_start > 0 && new_depth >= c.rr_start) {
    if (hash_uniform(S.seed, S.id, ctr + 3u) >= c.rr_q) {
      end = true;
    } else {
      S.weight = S.weight / c.rr_q;
    }
  }
  S.depth = new_depth;
  return end;
}

// The sample to its end, one march step at a time.
template <typename T>
__device__ __forceinline__ void trace_sample(Sample& S, const T* __restrict__ dens,
                                             const T* __restrict__ insc, int nx, int ny,
                                             int nz, const float* __restrict__ eval_rows,
                                             const float* __restrict__ inv,
                                             const PtConsts& c) {
  while (S.steps < c.max_steps) {
    const float ax = S.px + S.dx * c.step, ay = S.py + S.dy * c.step,
                az = S.pz + S.dz * c.step;
    const float density =
        trilinear(dens, nx, ny, nz, ax / c.bbox[0], ay / c.bbox[1], az / c.bbox[2]) *
        c.dm;
    const float tn = S.trans * expf(-density * c.step);
    ++S.steps;
    if (!(S.od > tn)) {
      if (free_step(S, c, ax, ay, az, tn)) return;
      continue;
    }
    if (scatter(S, insc, nx, ny, nz, eval_rows, inv, c, ax, ay, az, density, tn)) return;
  }
}

// A march step whose transmittance fell below od: where it landed, its
// density and the transmittance after it (scatter's arguments).
struct Crossing {
  float ax, ay, az;
  float density;
  float tn;
};

// kParked: K9's stop before a step (another rank's cell, the phase's
// budget); the sample goes on in a later phase.
enum : int { kMarching = 0, kEnded = 1, kCrossed = 2, kParked = 3 };

// The stop rule of a sample's march: K4's step cap, tested before each
// step (`steps` taken so far, uz the step's normalized z coordinate); where
// it stops, the march returns kState.
struct StepCap {
  static constexpr int kState = kEnded;
  int max_steps;
  __device__ __forceinline__ bool operator()(int steps, float /*uz*/) const {
    return steps >= max_steps;
  }
};

// Up to K march steps of the sample with the same values as K rounds of
// trace_sample's loop without its scatter: the K steps' densities and
// factors first, as independent chains, then the stop rule, transmittance
// updates and tests in order (a loop without early exits, so that it
// unrolls and the arrays stay in registers).  Returns the stop rule's
// kState where it stopped the march before a step (K4: kEnded at the cap),
// kEnded where the sample ended (box exit), kCrossed where a step crossed
// od (X holds it; the sample stands at the step before), else kMarching.
// zmap: where the density stores a plane (WholeZ; K9's slab).
template <int K, typename T, typename Z, typename Stop>
__device__ __forceinline__ int march_steps(Sample& S, Crossing& X, const T* __restrict__ dens,
                                           int nx, int ny, int nz, const PtConsts& c, Z zmap,
                                           Stop stop) {
  float dens_k[K], e_k[K], uz_k[K];
  float qx = S.px, qy = S.py, qz = S.pz;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    qx = qx + S.dx * c.step;
    qy = qy + S.dy * c.step;
    qz = qz + S.dz * c.step;
    dens_k[k] = trilinear_strided(dens, nx, ny, nz, div_exact(qx, c.bbox[0], c.inv_bbox[0]),
                                  div_exact(qy, c.bbox[1], c.inv_bbox[1]),
                                  div_exact(qz, c.bbox[2], c.inv_bbox[2]), zmap) *
                c.dm;
    uz_k[k] = div_exact(qz, c.bbox[2], c.inv_bbox[2]);
    e_k[k] = expf(-dens_k[k] * c.step);
  }
  int state = kMarching;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (state == kMarching) {
      if (stop(S.steps, uz_k[k])) {
        state = Stop::kState;
      } else {
        const float ax = S.px + S.dx * c.step, ay = S.py + S.dy * c.step,
                    az = S.pz + S.dz * c.step;
        const float tn = S.trans * e_k[k];
        ++S.steps;
        if (S.od > tn) {
          X.ax = ax;
          X.ay = ay;
          X.az = az;
          X.density = dens_k[k];
          X.tn = tn;
          state = kCrossed;
        } else if (free_step(S, c, ax, ay, az, tn)) {
          state = kEnded;
        }
      }
    }
  }
  return state;
}

// K4's march: the whole grid, the step cap.
template <int K, typename T>
__device__ __forceinline__ int march_steps(Sample& S, Crossing& X, const T* __restrict__ dens,
                                           int nx, int ny, int nz, const PtConsts& c) {
  return march_steps<K>(S, X, dens, nx, ny, nz, c, WholeZ(), StepCap{c.max_steps});
}

// march_steps with a skip (csrc/skip.cuh), K4's stop rule on the lattice
// steps advanced (S.steps + S.jumped, so that a capped sample stops at the
// same lattice point with or without the skip): the same values as the
// plain loop render/pathtracer.py::scatter_loop_plain with that skip.
//   kSkipBlock: each step's length from the occupancy at the point it
//     leaves (at most the lattice steps left); positions stay geometric,
//     so the first pass still walks the K steps ahead.
//   kSkipCell: the first pass also takes each step's corner maximum; a
//     step into an empty cell that leaves the sample in flight jumps it to
//     the cell's exit face and ends the chunk there (the steps after it
//     start from the jump), as a crossing does.  This is the cell jump's
//     first design; the kernels take march_steps_jump, which keeps its
//     values, and csrc/pathtrace_variants.cu and the host tests this one.
template <int K, int Skip, typename T>
__device__ __forceinline__ int march_steps_skip(Sample& S, Crossing& X,
                                                const T* __restrict__ dens, int nx, int ny,
                                                int nz, const PtConsts& c, const SkipArgs& sk) {
  float dens_k[K], e_k[K], len_k[K];
  int m_k[K];
  bool zero_k[K];
  float qx = S.px, qy = S.py, qz = S.pz;
  int adv = S.steps + S.jumped;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int m = 1;
    float len = c.step;
    if (Skip == kSkipBlock) {
      m = block_steps(sk, nx, ny, nz, div_exact(qx, c.bbox[0], c.inv_bbox[0]),
                      div_exact(qy, c.bbox[1], c.inv_bbox[1]),
                      div_exact(qz, c.bbox[2], c.inv_bbox[2]), c.max_steps - adv);
      len = c.step * (float)m;
    }
    adv += m;
    qx = qx + S.dx * len;
    qy = qy + S.dy * len;
    qz = qz + S.dz * len;
    float cmax;
    dens_k[k] = trilinear_strided_max(dens, nx, ny, nz, div_exact(qx, c.bbox[0], c.inv_bbox[0]),
                                      div_exact(qy, c.bbox[1], c.inv_bbox[1]),
                                      div_exact(qz, c.bbox[2], c.inv_bbox[2]), cmax) *
                c.dm;
    zero_k[k] = Skip == kSkipCell && cmax <= 0.0f;
    e_k[k] = expf(-dens_k[k] * c.step);
    len_k[k] = len;
    m_k[k] = m;
  }
  int state = kMarching;
  bool jumped = false;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (state == kMarching && !jumped) {
      if (S.steps + S.jumped >= c.max_steps) {
        state = kEnded;
      } else {
        const float ax = S.px + S.dx * len_k[k], ay = S.py + S.dy * len_k[k],
                    az = S.pz + S.dz * len_k[k];
        const float tn = S.trans * e_k[k];
        ++S.steps;
        S.jumped += m_k[k] - 1;
        if (S.od > tn) {
          X.ax = ax;
          X.ay = ay;
          X.az = az;
          X.density = dens_k[k];
          X.tn = tn;
          state = kCrossed;
        } else if (free_step(S, c, ax, ay, az, tn)) {
          state = kEnded;
        } else if (zero_k[k]) {
          const float e = cell_exit_steps(
              nx, ny, nz, c.bbox, c.step, div_exact(ax, c.bbox[0], c.inv_bbox[0]),
              div_exact(ay, c.bbox[1], c.inv_bbox[1]), div_exact(az, c.bbox[2], c.inv_bbox[2]),
              ax, ay, az, S.dx, S.dy, S.dz, c.max_steps - (S.steps + S.jumped));
          if (e > 0.0f) {
            const float d = e * c.step;
            S.px = S.px + S.dx * d;
            S.py = S.py + S.dy * d;
            S.pz = S.pz + S.dz * d;
            S.jumped += (int)e;
            jumped = true;
          }
        }
      }
    }
  }
  return state;
}

// The cell jump of K4 and K7b (kSkipCell, kSkipCellPow2): march_steps_skip's
// values, with the jump inside the chunk.  The first pass takes each step's
// taps, cell and empty test; after a step into an empty cell it takes the
// jump's exit (`jump_exit`: FaceExit, or DividedExit as the first design
// computes it) with the lattice steps left before the cap, and moves the
// chunk's later steps past the jump, so that they start from the jumped
// point.  The second pass applies the same jump after the same step where
// the sample is still in flight.  Where a step instead crossed od, left the box or
// met the cap, the chunk's later steps are dropped, as every march drops
// them, so the values are those of the jump that ends its chunk
// (march_steps_skip, the first design).  An empty cell's step has density
// at most 0, so it never crosses od: only box exits and the cap end a
// chunk there.
template <int K, typename T, typename Exit>
__device__ __forceinline__ int march_steps_jump(Sample& S, Crossing& X,
                                                const T* __restrict__ dens, int nx, int ny,
                                                int nz, const PtConsts& c,
                                                const Exit& jump_exit) {
  float dens_k[K], e_k[K], jump_k[K];
  float qx = S.px, qy = S.py, qz = S.pz;
  int adv = S.steps + S.jumped;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    qx = qx + S.dx * c.step;
    qy = qy + S.dy * c.step;
    qz = qz + S.dz * c.step;
    const float ux = div_exact(qx, c.bbox[0], c.inv_bbox[0]);
    const float uy = div_exact(qy, c.bbox[1], c.inv_bbox[1]);
    const float uz = div_exact(qz, c.bbox[2], c.inv_bbox[2]);
    int cx, cy, cz;
    bool empty;
    dens_k[k] = trilinear_cell(dens, nx, ny, nz, ux, uy, uz, cx, cy, cz, empty) * c.dm;
    e_k[k] = expf(-dens_k[k] * c.step);
    ++adv;
    float e = 0.0f;
    if (empty) {
      e = jump_exit(cx, cy, cz, ux, uy, uz, qx, qy, qz, S.dx, S.dy, S.dz, c.max_steps - adv);
      if (e > 0.0f) {
        const float d = e * c.step;
        qx = qx + S.dx * d;
        qy = qy + S.dy * d;
        qz = qz + S.dz * d;
        adv += (int)e;
      }
    }
    jump_k[k] = e;
  }
  int state = kMarching;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (state == kMarching) {
      if (S.steps + S.jumped >= c.max_steps) {
        state = kEnded;
      } else {
        const float ax = S.px + S.dx * c.step, ay = S.py + S.dy * c.step,
                    az = S.pz + S.dz * c.step;
        const float tn = S.trans * e_k[k];
        ++S.steps;
        if (S.od > tn) {
          X.ax = ax;
          X.ay = ay;
          X.az = az;
          X.density = dens_k[k];
          X.tn = tn;
          state = kCrossed;
        } else if (free_step(S, c, ax, ay, az, tn)) {
          state = kEnded;
        } else if (jump_k[k] > 0.0f) {
          const float d = jump_k[k] * c.step;
          S.px = S.px + S.dx * d;
          S.py = S.py + S.dy * d;
          S.pz = S.pz + S.dz * d;
          S.jumped += (int)jump_k[k];
        }
      }
    }
  }
  return state;
}

// The block skip of K4 (kSkipBlock): march_steps_skip's values, with the
// occupancy read only where it can be empty.  `sure` (the sample's, 0
// where it starts and after a crossing) counts the plain steps certain
// from its position, where block_steps would give 1: build_occupancy
// dilates by a block, so a step that lands at p in a cell with a nonzero
// corner (the taps' empty test) leaves p and every lattice point up to
// `sure_steps` plain steps past it in an occupied block
// (ops/march.py::block_sure_steps, proved by
// tests/test_torch_block_host.py).  The first pass takes a step's length
// from `blocks` (skip.cuh::BitBlocks, or a reader with its steps()) only
// where the count at the chunk's start does not cover it, so the taps of a
// covered chunk's steps stay independent; the second pass sets the count
// after each step taken: sure_steps after a step into a cell with a
// nonzero corner, else one less than before.
template <int K, typename T, typename Blocks>
__device__ __forceinline__ int march_steps_block(Sample& S, Crossing& X,
                                                 const T* __restrict__ dens, int nx, int ny,
                                                 int nz, const PtConsts& c, const Blocks& blocks,
                                                 int sure_steps, int& sure) {
  float dens_k[K], e_k[K], len_k[K];
  int m_k[K];
  bool held_k[K];
  float qx = S.px, qy = S.py, qz = S.pz;
  int adv = S.steps + S.jumped;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int m =
        sure <= k ? blocks.steps(nx, ny, nz, c.bbox, c.inv_bbox, qx, qy, qz, c.max_steps - adv)
                  : 1;
    const float len = c.step * (float)m;
    adv += m;
    qx = qx + S.dx * len;
    qy = qy + S.dy * len;
    qz = qz + S.dz * len;
    int cx, cy, cz;
    bool empty;
    dens_k[k] = trilinear_cell(dens, nx, ny, nz, div_exact(qx, c.bbox[0], c.inv_bbox[0]),
                               div_exact(qy, c.bbox[1], c.inv_bbox[1]),
                               div_exact(qz, c.bbox[2], c.inv_bbox[2]), cx, cy, cz, empty) *
                c.dm;
    held_k[k] = !empty;
    e_k[k] = expf(-dens_k[k] * c.step);
    len_k[k] = len;
    m_k[k] = m;
  }
  int state = kMarching;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (state == kMarching) {
      if (S.steps + S.jumped >= c.max_steps) {
        state = kEnded;
      } else {
        const float ax = S.px + S.dx * len_k[k], ay = S.py + S.dy * len_k[k],
                    az = S.pz + S.dz * len_k[k];
        const float tn = S.trans * e_k[k];
        ++S.steps;
        S.jumped += m_k[k] - 1;
        const int next = sure > 0 ? sure - 1 : 0;
        sure = held_k[k] && sure_steps > next ? sure_steps : next;
        if (S.od > tn) {
          X.ax = ax;
          X.ay = ay;
          X.az = az;
          X.density = dens_k[k];
          X.tn = tn;
          sure = 0;
          state = kCrossed;
        } else if (free_step(S, c, ax, ay, az, tn)) {
          state = kEnded;
        }
      }
    }
  }
  return state;
}

// K4's march step at lookahead K with skip Skip: march_steps as it was
// (kSkipNone), march_steps_jump with the exit `jump` (the cell jump) or
// march_steps_skip.
template <int K, int Skip, typename T, typename Exit>
__device__ __forceinline__ int march_steps_any(Sample& S, Crossing& X, const T* __restrict__ dens,
                                               int nx, int ny, int nz, const PtConsts& c,
                                               const SkipArgs& sk, const Exit& jump) {
  if constexpr (Skip == kSkipNone) {
    return march_steps<K>(S, X, dens, nx, ny, nz, c);
  } else if constexpr (kCellJump<Skip>) {
    return march_steps_jump<K>(S, X, dens, nx, ny, nz, c, jump);
  } else {
    return march_steps_skip<K, Skip>(S, X, dens, nx, ny, nz, c, sk);
  }
}

// The crossing X's scatter (NEE, the next flight): true where the sample
// ends.
template <typename T, typename Z = WholeZ>
__device__ __forceinline__ bool resolve(Sample& S, const Crossing& X, const T* __restrict__ insc,
                                        int nx, int ny, int nz,
                                        const float* __restrict__ eval_rows,
                                        const float* __restrict__ inv, const PtConsts& c,
                                        Z zmap = Z()) {
  return scatter(S, insc, nx, ny, nz, eval_rows, inv, c, X.ax, X.ay, X.az, X.density, X.tn,
                 zmap);
}

// Up to K march steps and, where one crossed od, its scatter: the same
// values as K rounds of trace_sample's loop.  True where the sample ended.
template <int K, typename T>
__device__ __forceinline__ bool march_chunk(Sample& S, const T* __restrict__ dens,
                                            const T* __restrict__ insc, int nx, int ny,
                                            int nz, const float* __restrict__ eval_rows,
                                            const float* __restrict__ inv,
                                            const PtConsts& c) {
  Crossing X;
  const int state = march_steps<K>(S, X, dens, nx, ny, nz, c);
  if (state == kCrossed) return resolve(S, X, insc, nx, ny, nz, eval_rows, inv, c);
  return state == kEnded;
}

// march_chunk with skip Skip (march_steps_skip).
template <int K, int Skip, typename T>
__device__ __forceinline__ bool march_chunk_skip(Sample& S, const T* __restrict__ dens,
                                                 const T* __restrict__ insc, int nx, int ny,
                                                 int nz, const float* __restrict__ eval_rows,
                                                 const float* __restrict__ inv,
                                                 const PtConsts& c, const SkipArgs& sk) {
  Crossing X;
  const int state = march_steps_skip<K, Skip>(S, X, dens, nx, ny, nz, c, sk);
  if (state == kCrossed) return resolve(S, X, insc, nx, ny, nz, eval_rows, inv, c);
  return state == kEnded;
}

// march_chunk with the cell jump of march_steps_jump.
template <int K, typename T, typename Exit>
__device__ __forceinline__ bool march_chunk_jump(Sample& S, const T* __restrict__ dens,
                                                 const T* __restrict__ insc, int nx, int ny,
                                                 int nz, const float* __restrict__ eval_rows,
                                                 const float* __restrict__ inv,
                                                 const PtConsts& c, const Exit& jump_exit) {
  Crossing X;
  const int state = march_steps_jump<K>(S, X, dens, nx, ny, nz, c, jump_exit);
  if (state == kCrossed) return resolve(S, X, insc, nx, ny, nz, eval_rows, inv, c);
  return state == kEnded;
}

// march_chunk with the block skip of march_steps_block.
template <int K, typename T, typename Blocks>
__device__ __forceinline__ bool march_chunk_block(Sample& S, const T* __restrict__ dens,
                                                  const T* __restrict__ insc, int nx, int ny,
                                                  int nz, const float* __restrict__ eval_rows,
                                                  const float* __restrict__ inv,
                                                  const PtConsts& c, const Blocks& blocks,
                                                  int sure_steps, int& sure) {
  Crossing X;
  const int state = march_steps_block<K>(S, X, dens, nx, ny, nz, c, blocks, sure_steps, sure);
  if (state == kCrossed) return resolve(S, X, insc, nx, ny, nz, eval_rows, inv, c);
  return state == kEnded;
}

// A skipping kernel's count of the lattice steps that item `item`'s sample
// S jumped, added to its pixel's (nothing without a skip).
template <int Skip>
__device__ __forceinline__ void add_jumped(const SkipArgs& sk, int64_t item, int64_t n,
                                           const Sample& S) {
  if constexpr (Skip != kSkipNone) {
#ifdef DS_HOST_EMULATION
    sk.jumped[item % n] += (unsigned long long)S.jumped;
#else
    if (S.jumped != 0) atomicAdd(&sk.jumped[item % n], (unsigned long long)S.jumped);
#endif
  }
}

// K7b's warp step: resolve the parked crossings (every lane with one)
// where at least park_at lanes of the warp's live lanes are parked or none
// marches; else march.  n_parked and n_live are counts over the warp.
__device__ __forceinline__ bool resolve_now(int n_parked, int n_live, int park_at) {
  return n_parked >= park_at || n_parked == n_live;
}

// Welford update of (mean, m2, cnt) with one sample's radiance.
__device__ __forceinline__ void welford_add(float* mean, float* m2, float& cnt,
                                            const float* rad) {
  const float cnt_new = cnt + 1.0f;
  const float nsafe = fmaxf(cnt_new, 1.0f);
  for (int i = 0; i < 3; ++i) {
    const float delta = rad[i] - mean[i];
    const float mean_new = mean[i] + delta / nsafe;
    m2[i] = m2[i] + delta * (rad[i] - mean_new);
    mean[i] = mean_new;
  }
  cnt = cnt_new;
}

// The seed of sample k of pixel r: its experiment base is sub0[r] where
// sub0 is given (K7b), else sub_first (K4).
__device__ __forceinline__ uint32_t sample_seed(uint32_t seed_base, uint32_t sub_first,
                                                const uint32_t* __restrict__ sub0,
                                                int64_t r, uint32_t k) {
  const uint32_t base = sub0 != nullptr ? sub0[r] : sub_first;
  return seed_base ^ ((base + k) * 0x9E3779B1u);
}

// The estimator as one loop over pixel r's samples, one step at a time.
template <typename T>
__device__ __forceinline__ void pathtrace_pixel(
    int64_t r, const T* __restrict__ dens, const T* __restrict__ insc, int nx, int ny,
    int nz, const float* __restrict__ eval_rows, const float* __restrict__ inv,
    const float* __restrict__ entry, const float* __restrict__ dirs,
    const uint8_t* __restrict__ hit, const int64_t* __restrict__ ray_ids,
    const PtConsts& c, uint32_t seed_base, uint32_t sub_first, int n_samples,
    float* __restrict__ mean_out, float* __restrict__ m2_out,
    float* __restrict__ count_out, int64_t* __restrict__ work_out,
    const uint32_t* __restrict__ sub0 = nullptr) {
  float mean[3] = {0.0f, 0.0f, 0.0f}, m2[3] = {0.0f, 0.0f, 0.0f};
  float cnt = 0.0f;
  int64_t steps = 0, bounces = 0;
  if (hit[r]) {
    const float ex = entry[3 * r], ey = entry[3 * r + 1], ez = entry[3 * r + 2];
    const bool entry_in = in_box(ex, ey, ez, c.bbox);
    for (int k = 0; k < n_samples; ++k) {
      const uint32_t seed = sample_seed(seed_base, sub_first, sub0, r, (uint32_t)k);
      float rad[3] = {0.0f, 0.0f, 0.0f};
      if (entry_in) {
        Sample S;
        begin_sample(S, c, inv, seed, (uint32_t)ray_ids[r], ex, ey, ez, dirs[3 * r],
                     dirs[3 * r + 1], dirs[3 * r + 2]);
        trace_sample(S, dens, insc, nx, ny, nz, eval_rows, inv, c);
        for (int i = 0; i < 3; ++i) rad[i] = S.rad[i];
        steps += S.steps;
        bounces += S.bounces;
      }
      welford_add(mean, m2, cnt, rad);
    }
  }
  for (int i = 0; i < 3; ++i) {
    mean_out[3 * r + i] = mean[i];
    m2_out[3 * r + i] = m2[i];
  }
  count_out[r] = cnt;
  work_out[2 * r] = steps;
  work_out[2 * r + 1] = bounces;
}

// The per-sample record of item `item` (= sample * N + pixel).
__device__ __forceinline__ void write_record(const Sample& S, int64_t item,
                                             float* __restrict__ rec_rad,
                                             int32_t* __restrict__ rec_work) {
  for (int i = 0; i < 3; ++i) rec_rad[3 * item + i] = S.rad[i];
  rec_work[2 * item] = S.steps;
  rec_work[2 * item + 1] = S.bounces;
}

// Starts work item `item` (sample item / n of pixel item % n).  True where
// the sample has steps to march.  A pixel without a box hit has no
// records; a sample whose entry lies outside the box gets a zero record.
__device__ __forceinline__ bool begin_item(
    Sample& S, int64_t item, int64_t n, const float* __restrict__ entry,
    const float* __restrict__ dirs, const uint8_t* __restrict__ hit,
    const int64_t* __restrict__ ray_ids, const float* __restrict__ inv,
    const PtConsts& c, uint32_t seed_base, uint32_t sub_first,
    const uint32_t* __restrict__ sub0, float* __restrict__ rec_rad,
    int32_t* __restrict__ rec_work) {
  const int64_t r = item % n;
  const uint32_t k = (uint32_t)(item / n);
  if (!hit[r]) return false;
  const float ex = entry[3 * r], ey = entry[3 * r + 1], ez = entry[3 * r + 2];
  const uint32_t seed = sample_seed(seed_base, sub_first, sub0, r, k);
  begin_sample(S, c, inv, seed, (uint32_t)ray_ids[r], ex, ey, ez, dirs[3 * r],
               dirs[3 * r + 1], dirs[3 * r + 2]);
  if (in_box(ex, ey, ez, c.bbox)) return true;
  write_record(S, item, rec_rad, rec_work);  // begin_sample zeroed it
  return false;
}

// Pixel r's records folded in sample order (the expressions of
// pathtrace_pixel); zeros where the pixel has no box hit.
__device__ __forceinline__ void fold_pixel(int64_t r, int64_t n, int n_samples,
                                           const uint8_t* __restrict__ hit,
                                           const float* __restrict__ rec_rad,
                                           const int32_t* __restrict__ rec_work,
                                           float* __restrict__ mean_out,
                                           float* __restrict__ m2_out,
                                           float* __restrict__ count_out,
                                           int64_t* __restrict__ work_out) {
  float mean[3] = {0.0f, 0.0f, 0.0f}, m2[3] = {0.0f, 0.0f, 0.0f};
  float cnt = 0.0f;
  int64_t steps = 0, bounces = 0;
  if (hit[r]) {
    for (int k = 0; k < n_samples; ++k) {
      const int64_t i = (int64_t)k * n + r;
      const float rad[3] = {rec_rad[3 * i], rec_rad[3 * i + 1], rec_rad[3 * i + 2]};
      welford_add(mean, m2, cnt, rad);
      steps += rec_work[2 * i];
      bounces += rec_work[2 * i + 1];
    }
  }
  for (int i = 0; i < 3; ++i) {
    mean_out[3 * r + i] = mean[i];
    m2_out[3 * r + i] = m2[i];
  }
  count_out[r] = cnt;
  work_out[2 * r] = steps;
  work_out[2 * r + 1] = bounces;
}

// consts: bbox[3], step, dm, light_dir[3], light_radiance[3],
// sun_solid_angle_ratio, sun_cos_half_angle, rr_survival, sky[3] (16 + 3
// host floats); ground[3].
inline PtConsts pt_consts(const float* k, const float* ground, int max_steps,
                          int max_depth, int rr_start, int n_phase, int n_inv,
                          int flags) {
  PtConsts c;
  for (int i = 0; i < 3; ++i) {
    c.bbox[i] = k[i];
    c.inv_bbox[i] = pow2_recip(k[i]);
    c.light[i] = k[5 + i];
    c.radiance[i] = k[8 + i];
    c.sky[i] = k[14 + i];
    c.ground[i] = ground[i];
  }
  c.step = k[3];
  c.dm = k[4];
  c.sun_ratio = k[11];
  c.sun_cos_half = k[12];
  c.rr_q = k[13];
  c.max_steps = max_steps;
  c.max_depth = max_depth;
  c.rr_start = rr_start;
  c.n_phase = n_phase;
  c.n_inv = n_inv;
  c.flags = flags;
  return c;
}

}  // namespace ds
