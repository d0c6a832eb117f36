// K7a: the first-scatter sample generator of the dataset collector, a
// block of W warps per sample running W of its attempts at once.
//
// Replaces the XLA loop of deepestscatter_tpu/data/collectors.py::
// generate_scatter_samples (lines 59-121): a masked lax.while_loop of up to
// 256 attempts over every sample in lockstep, each attempt a box hit and a
// next_scattering_event march (stop_at_scatter=True).
//
// Per sample s (stream s of the seed), attempt k = 0 .. 255 draws at
// counters 8k .. 8k+4: a uniform sphere normal n (u1, u2), a uniform disc
// point of radius sqrt(3)/2 in n's frame (u3, u4), the optical distance od;
// the ray starts at disc + 2 n and runs along -n; the slab test against the
// centred box gives the entry (t clamped to minimal_ray_distance), and the
// march from there (K1's: the jump to the cloud AABB on the step lattice,
// then pos += dir * step, T *= exp(-sigma step)) stops at the first step
// with od > T, the scatter pulled back by log(od / T) / sigma.  With a
// skip (ds_samples_skip; the JAX package's next_scattering_event,
// ops/march.py:199-262) the march takes the block skip's long steps or the
// cell jump (csrc/skip.cuh): a chunk of lanes ends before its first step of
// the other kind, or after its first step into an empty cell, whose jump
// the group then takes once.  The first
// attempt whose ray hit the box and scattered inside it (+-0.01 margin)
// gives the sample: the scatter point in world-centred coordinates (minus
// bbox / 2) and the ray's direction.  A sample that does not scatter in 256
// attempts keeps zeros, as the JAX loop leaves it (the reference,
// pointGeneratorCamera.cu:20-42, loops until it scatters).  sample_attempts
// below states this as a loop over one sample's attempts; the kernel makes
// the same attempts in rounds, W at a time.
//
// Float expressions follow data/collectors.py::generate_scatter_samples_plain
// (ops/rng.py uniform_on_sphere, uniform_on_disc, make_onb;
// render/camera.py intersect_box, entry_points) term by term; the build
// uses -fmad=false.
//
// Bound on the card: operations.  The 2,048 samples of a scene need a few
// attempts each (about a third of the disc rays miss the cloud) and a march
// of up to ~900 steps an attempt: ~74 operations a step (K1's count) and
// ~150 an attempt (four hashes, sphere and disc samples, two frames, the
// slab test).  The data is small; the time is the longest sample's chain.
// What held the first design back (a warp a sample walking its attempts in
// order, 0.1168 ms for the collector's 2,048 samples on an H100 at 700 W,
// 23x its bound): 2,048 warps fill 65 k of the card's ~270 k thread slots,
// and the batch lasts as long as its longest chain of attempts (mean 6.53,
// max 56 on the collector's scene: 56 marches in a row).
// Design:
//   1. Attempts are independent (attempt k draws from counters 8k .. 8k+4
//      of the sample's stream alone), so a block of W = kSampleWarps warps
//      takes a sample and makes its attempts in rounds: in round j warp w
//      makes attempt jW + w.  The longest chain becomes ceil(56 / W)
//      rounds, and the card holds W times the threads.
//   2. Each warp marches its attempt with K1's chunk functions on 32
//      consecutive steps (lane_step, lane_transmittance, chunk_end with
//      stop_at_cross, chunk_update), as the first design did.
//   3. A round ends with its warps' accepted flags and step counts in
//      shared memory; round_end (the same on every thread) picks the
//      smallest accepted attempt and sums the steps the serial loop counts:
//      every attempt of a round without a winner, and of the winning round
//      only those up to the winner.  The winner's warp writes the sample
//      (attempts = winner + 1); work past the winner is dropped.  A sample
//      without a winner in 256 attempts keeps zeros.
// The first design (a warp a sample, and K1's 8 lanes a sample) is kept in
// march_variants.cu and timed beside this one by probes/march_variants.py.
// Values equal sample_attempts' bitwise.  Each sample's attempts and steps
// are written out beside it.
//
// The cell jump (ds_samples_skip with kSkipCell, samples_threads_kernel) is
// a redesign.  Its first design was this kernel with the jump in its lane
// chunks (kept in march_variants.cu): a chunk ended after its first lane
// in an empty cell and the group jumped once by cell_exit_steps' ten
// divisions.  In the collector's 258^3 grid at step 1/512 a cell spans
// about 2 steps, so in empty space a chunk of 32 lanes advanced about 2
// lattice steps a warp iteration where the chunk without the skip advances
// 32: 1.68-1.73 ms against 0.098 without the skip (H100 80GB HBM3 at 700
// W).  Here a thread makes an attempt (attempt_chunk_jump: K4's lookahead
// march with the jump inside the chunk, the exit from the face table,
// skip.cuh::FaceExit), so a jump costs no warp iteration; a group of
// kAttemptGroup lanes makes a sample's attempts in rounds of that many
// (the collector's samples need 6.53 attempts on the mean and 56 at most),
// and a round ends once its smallest accepted attempt and every attempt
// below it have ended.
#include "march.cu"

namespace ds {

constexpr int kMaxAttempts = 256;
// W: the warps a sample, each making one attempt a round.
constexpr int kSampleWarps = 8;
// The cell jump (samples_threads_kernel): the attempts a group of lanes
// makes at once (a thread an attempt), the lookahead of each thread's
// march, the threads a block.
constexpr int kAttemptGroup = 32;
constexpr int kAttemptLookahead = 4;
constexpr int kAttemptThreads = 128;
constexpr uint32_t kDrawsPerAttempt = 8u;
// float32(sqrt(3) / 2) and float32(2 pi), as torch rounds the Python
// constants.
constexpr float kSqrt3Half = (float)0.8660254037844386;
constexpr float kSampleTwoPi = (float)(2.0 * 3.141592653589793);

// An attempt's ray: its box entry (local coordinates), direction,
// optical distance and whether it hits the box.
struct AttemptRay {
  float ex, ey, ez;
  float dx, dy, dz;
  float od;
  bool hit;
};

// Attempt k of sample `id`: ops/rng.py::uniform_on_sphere and
// uniform_on_disc, then render/camera.py::intersect_box and entry_points.
__device__ __forceinline__ AttemptRay attempt_ray(uint32_t seed, uint32_t id, int k,
                                                  const MarchConsts& c, float min_dist) {
  const uint32_t ctr = (uint32_t)k * kDrawsPerAttempt;
  const float u1 = hash_uniform(seed, id, ctr);
  const float u2 = hash_uniform(seed, id, ctr + 1u);
  const float u3 = hash_uniform(seed, id, ctr + 2u);
  const float u4 = hash_uniform(seed, id, ctr + 3u);
  AttemptRay A;
  A.od = hash_uniform(seed, id, ctr + 4u);
  const float phi = u1 * kSampleTwoPi;
  const float ct = 2.0f * u2 - 1.0f;
  const float st = sqrtf(fmaxf(1.0f - ct * ct, 0.0f));
  const float nx = cosf(phi) * st, ny = sinf(phi) * st, nz = ct;
  const float theta = u3 * kSampleTwoPi;
  const float sr = sqrtf(u4);
  const float x = sr * cosf(theta), y = sr * sinf(theta);
  const float sign = nz >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + nz);
  const float b = (nx * ny) * a;
  const float t[3] = {1.0f + (sign * (nx * nx)) * a, sign * b, (-sign) * nx};
  const float bt[3] = {b, sign + (ny * ny) * a, -ny};
  const float n[3] = {nx, ny, nz};
  float o[3], d[3], t0[3], t1[3];
  for (int i = 0; i < 3; ++i) {
    const float disc = (x * t[i] + y * bt[i]) * kSqrt3Half;
    o[i] = disc + n[i] * 2.0f;
    d[i] = -n[i];
    const float half = c.bbox[i] * 0.5f;
    const float inv = 1.0f / d[i];
    t0[i] = (-half - o[i]) * inv;
    t1[i] = (half - o[i]) * inv;
  }
  const float t_near =
      fmaxf(fmaxf(fminf(t0[0], t1[0]), fminf(t0[1], t1[1])), fminf(t0[2], t1[2]));
  const float t_far =
      fminf(fminf(fmaxf(t0[0], t1[0]), fmaxf(t0[1], t1[1])), fmaxf(t0[2], t1[2]));
  A.hit = t_near < t_far && t_far > 0.0f;
  const float t_hit = fmaxf(t_near, min_dist);
  A.ex = (o[0] + d[0] * t_hit) + c.bbox[0] * 0.5f;
  A.ey = (o[1] + d[1] * t_hit) + c.bbox[1] * 0.5f;
  A.ez = (o[2] + d[2] * t_hit) + c.bbox[2] * 0.5f;
  A.dx = d[0];
  A.dy = d[1];
  A.dz = d[2];
  return A;
}

// The attempt's march state: K1's ray from the entry, not marched where
// the ray misses the box.
__device__ __forceinline__ void attempt_start(Ray& R, const AttemptRay& A,
                                              const MarchConsts& c) {
  ray_start(R, A.ex, A.ey, A.ez, A.dx, A.dy, A.dz, A.od, c);
  if (!A.hit) R.active = false;
}

// The sample's outputs once its attempt was accepted (R scattered inside
// the box) or its attempts ran out (found false: zeros).
__device__ __forceinline__ void sample_end(int64_t s, bool found, const Ray& R,
                                           const MarchConsts& c, int attempts, int steps,
                                           float* __restrict__ pos_out,
                                           float* __restrict__ dir_out,
                                           uint8_t* __restrict__ found_out,
                                           int32_t* __restrict__ work_out) {
  pos_out[3 * s] = found ? R.qx - c.bbox[0] * 0.5f : 0.0f;
  pos_out[3 * s + 1] = found ? R.qy - c.bbox[1] * 0.5f : 0.0f;
  pos_out[3 * s + 2] = found ? R.qz - c.bbox[2] * 0.5f : 0.0f;
  dir_out[3 * s] = found ? R.dx : 0.0f;
  dir_out[3 * s + 1] = found ? R.dy : 0.0f;
  dir_out[3 * s + 2] = found ? R.dz : 0.0f;
  found_out[s] = found ? 1 : 0;
  work_out[2 * s] = attempts;
  work_out[2 * s + 1] = steps;
}

__device__ __forceinline__ bool accepted(const Ray& R, const MarchConsts& c) {
  return R.scattered && in_box(R.qx, R.qy, R.qz, c.bbox);
}

// Attempt R marched one step at a time, to its crossing, exit or cap.
template <typename T>
__device__ __forceinline__ void attempt_march(Ray& R, const T* __restrict__ dens, int nx, int ny,
                                              int nz, const MarchConsts& c) {
  while (R.active) {
    const float ax = R.cx + R.dx * c.step, ay = R.cy + R.dy * c.step,
                az = R.cz + R.dz * c.step;
    const float density =
        trilinear(dens, nx, ny, nz, ax / c.bbox[0], ay / c.bbox[1], az / c.bbox[2]) * c.dm;
    const float tn = R.trans * expf(-density * c.step);
    R.trans = tn;
    R.cx = ax;
    R.cy = ay;
    R.cz = az;
    ++R.steps;
    if (R.od > tn) {
      const float back =
          logf(fmaxf(R.od, 1e-20f) / fmaxf(tn, 1e-20f)) / fmaxf(density, 1e-10f);
      R.qx = ax - R.dx * back;
      R.qy = ay - R.dy * back;
      R.qz = az - R.dz * back;
      R.scattered = true;
      break;
    }
    R.active = in_aabb(R.cx, R.cy, R.cz, c) && R.steps < c.max_steps;
  }
}

// The generator as one loop over sample s's attempts, one step at a time.
template <typename T>
__device__ __forceinline__ void sample_attempts(int64_t s, const T* __restrict__ dens, int nx,
                                                int ny, int nz, uint32_t seed,
                                                const MarchConsts& c, float min_dist,
                                                float* __restrict__ pos_out,
                                                float* __restrict__ dir_out,
                                                uint8_t* __restrict__ found_out,
                                                int32_t* __restrict__ work_out) {
  Ray R;
  bool found = false;
  int k = 0, steps = 0;
  while (!found && k < kMaxAttempts) {
    attempt_start(R, attempt_ray(seed, (uint32_t)s, k, c, min_dist), c);
    ++k;
    attempt_march(R, dens, nx, ny, nz, c);
    steps += R.steps;
    found = accepted(R, c);
  }
  sample_end(s, found, R, c, k, steps, pos_out, dir_out, found_out, work_out);
}

// The end of a round of W attempts first .. first + W - 1, attempt
// first + w made by warp w (one past kMaxAttempts is not made: no steps,
// not accepted).  Bit w of `accepted` is set where attempt first + w was
// accepted; steps[w] are its march steps.  winner: the smallest accepted
// attempt, or -1; steps: what the serial loop counts of the round, every
// attempt's where none was accepted, else those up to the winner's.
struct RoundEnd {
  int winner;
  int steps;
};

__device__ __forceinline__ RoundEnd round_end(int first, int W, unsigned accepted,
                                              const int* steps) {
  RoundEnd E;
  E.winner = -1;
  E.steps = 0;
  for (int w = 0; w < W; ++w) {
    E.steps += steps[w];
    if ((accepted >> w) & 1u) {
      E.winner = first + w;
      break;
    }
  }
  return E;
}

// The cell jump of K7a (samples_threads_kernel): up to K march steps of
// attempt R on one thread with the same values as K rounds of
// attempt_march with the jump (the lane chunks of attempt_march_lanes with
// kSkipCell, a chunk ended after its first step into an empty cell and the
// group's chunk_jump).  The first pass takes each step's position (the
// serial sum cur + dir * step), taps, cell and empty test and, after a
// step into an empty cell, the jump's exit (jump_exit: skip.cuh::FaceExit,
// no room) and moves the chunk's later steps past it by cur + dir * (e *
// step); the second pass applies T, the crossing (its scatter point), the
// AABB exit and the cap in step order, and the same jump after the same
// step where the attempt still marches.  An empty cell's step has density
// 0, so it never crosses od.
template <int K, typename T, typename Exit>
__device__ __forceinline__ void attempt_chunk_jump(Ray& R, const T* __restrict__ dens, int nx,
                                                   int ny, int nz, const MarchConsts& c,
                                                   const Exit& jump_exit) {
  float dens_k[K], e_k[K], jump_k[K], ax_k[K], ay_k[K], az_k[K];
  float qx = R.cx, qy = R.cy, qz = R.cz;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    qx = qx + R.dx * c.step;
    qy = qy + R.dy * c.step;
    qz = qz + R.dz * c.step;
    ax_k[k] = qx;
    ay_k[k] = qy;
    az_k[k] = qz;
    const float ux = div_exact(qx, c.bbox[0], c.inv_bbox[0]);
    const float uy = div_exact(qy, c.bbox[1], c.inv_bbox[1]);
    const float uz = div_exact(qz, c.bbox[2], c.inv_bbox[2]);
    int cx, cy, cz;
    bool empty;
    dens_k[k] = trilinear_cell(dens, nx, ny, nz, ux, uy, uz, cx, cy, cz, empty) * c.dm;
    e_k[k] = expf(-dens_k[k] * c.step);
    float e = 0.0f;
    if (empty) {
      e = jump_exit(cx, cy, cz, ux, uy, uz, qx, qy, qz, R.dx, R.dy, R.dz, 0x7fffffff);
      if (e > 0.0f) {
        const float d = e * c.step;
        qx = qx + R.dx * d;
        qy = qy + R.dy * d;
        qz = qz + R.dz * d;
      }
    }
    jump_k[k] = e;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (R.active) {
      const float tn = R.trans * e_k[k];
      R.trans = tn;
      R.cx = ax_k[k];
      R.cy = ay_k[k];
      R.cz = az_k[k];
      ++R.steps;
      if (R.od > tn) {
        const float back =
            logf(fmaxf(R.od, 1e-20f) / fmaxf(tn, 1e-20f)) / fmaxf(dens_k[k], 1e-10f);
        R.qx = ax_k[k] - R.dx * back;
        R.qy = ay_k[k] - R.dy * back;
        R.qz = az_k[k] - R.dz * back;
        R.scattered = true;
        R.active = false;
      } else {
        R.active = in_aabb(R.cx, R.cy, R.cz, c) && R.steps < c.max_steps;
        if (R.active && jump_k[k] > 0.0f) {
          const float d = jump_k[k] * c.step;
          R.cx = R.cx + R.dx * d;
          R.cy = R.cy + R.dy * d;
          R.cz = R.cz + R.dz * d;
        }
      }
    }
  }
}

}  // namespace ds

#ifndef DS_HOST_EMULATION

// Attempt R marched by a group of G lanes on consecutive steps (K1's chunk
// functions); gl is this lane's place in the group, gmask the group's
// lanes in the warp, shift its first lane.
template <int G, typename T, int Skip = ds::kSkipNone>
__device__ __forceinline__ void attempt_march_lanes(ds::Ray& R, int gl, unsigned gmask,
                                                    int shift, const T* __restrict__ dens,
                                                    int nx, int ny, int nz,
                                                    const ds::MarchConsts& c,
                                                    const ds::SkipArgs& sk = ds::SkipArgs()) {
  while (R.active) {
    ds::LaneSkip F = {false, false};
    ds::LaneStep S;
    if constexpr (Skip == ds::kSkipNone) {
      S = ds::lane_step<G>(R, gl, dens, nx, ny, nz, c);
    } else {
      S = ds::lane_step_skip<G, Skip>(R, gl, dens, nx, ny, nz, c, sk, F);
    }
    S.tn = ds::lane_transmittance<G>(R.trans, gl, [&](int j) {
      return __shfl_sync(gmask, S.e, j, G);
    });
    const unsigned leaves = __ballot_sync(gmask, ds::lane_leaves(S, c)) >> shift;
    const unsigned crosses = __ballot_sync(gmask, ds::lane_crosses(R, S)) >> shift;
    ds::ChunkEnd E;
    bool jump = false;
    if constexpr (Skip == ds::kSkipNone) {
      E = ds::chunk_end(leaves, crosses, c.max_steps - R.steps, G, true);
    } else {
      const unsigned cuts = __ballot_sync(gmask, F.cut) >> shift;
      const unsigned empties = __ballot_sync(gmask, F.empty) >> shift;
      E = ds::chunk_end_skip(leaves, crosses, cuts, empties, c.max_steps - R.steps, G, true,
                             jump);
    }
    ds::chunk_update(R, E, [&](int j) {
      ds::LaneStep X;
      X.ax = __shfl_sync(gmask, S.ax, j, G);
      X.ay = __shfl_sync(gmask, S.ay, j, G);
      X.az = __shfl_sync(gmask, S.az, j, G);
      X.density = __shfl_sync(gmask, S.density, j, G);
      X.e = 0.0f;
      X.tn = __shfl_sync(gmask, S.tn, j, G);
      return X;
    });
    if (jump) ds::chunk_jump(R, nx, ny, nz, c);
  }
}

// A block of W warps per sample (block b takes sample b): round j's
// attempts jW .. jW + W - 1, warp w making attempt jW + w with 32 lanes;
// the round's flags and steps meet in shared memory, and the block stops
// after the first round that accepts an attempt.
template <int W, typename T, int Skip = ds::kSkipNone>
__global__ void __launch_bounds__(32 * W) samples_rounds_kernel(
    const T* __restrict__ dens, int nx, int ny, int nz, uint32_t seed, ds::MarchConsts c,
    float min_dist, float* __restrict__ pos_out, float* __restrict__ dir_out,
    uint8_t* __restrict__ found_out, int32_t* __restrict__ work_out, ds::SkipArgs sk) {
  __shared__ int s_steps[W];
  __shared__ unsigned s_accepted;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t s = blockIdx.x;
  ds::Ray R;
  int steps = 0;
  for (int first = 0; first < ds::kMaxAttempts; first += W) {
    if (threadIdx.x == 0) s_accepted = 0u;
    __syncthreads();
    const int k = first + w;
    if (k < ds::kMaxAttempts) {  // uniform over the warp
      ds::attempt_start(R, ds::attempt_ray(seed, (uint32_t)s, k, c, min_dist), c);
      attempt_march_lanes<32, T, Skip>(R, lane, 0xffffffffu, 0, dens, nx, ny, nz, c, sk);
      if (lane == 0) {
        s_steps[w] = R.steps;
        if (ds::accepted(R, c)) atomicOr(&s_accepted, 1u << w);
      }
    } else if (lane == 0) {
      s_steps[w] = 0;
    }
    __syncthreads();
    const ds::RoundEnd E = ds::round_end(first, W, s_accepted, s_steps);
    steps += E.steps;
    if (E.winner >= 0) {  // uniform over the block
      if (k == E.winner && lane == 0) {
        ds::sample_end(s, true, R, c, E.winner + 1, steps, pos_out, dir_out, found_out,
                       work_out);
      }
      return;
    }
    __syncthreads();  // every thread has read s_steps and s_accepted
  }
  if (threadIdx.x == 0) {
    ds::sample_end(s, false, R, c, ds::kMaxAttempts, steps, pos_out, dir_out, found_out,
                   work_out);
  }
}

template <int W, int Skip = ds::kSkipNone>
static int samples_rounds(const void* dens, int is_u8, int nx, int ny, int nz, uint32_t seed,
                          int64_t n, const ds::MarchConsts& c, float min_dist, float* pos_out,
                          float* dir_out, uint8_t* found_out, int32_t* work_out,
                          cudaStream_t s, const ds::SkipArgs& sk = ds::SkipArgs()) {
  static_assert(W >= 1 && W <= 32, "W: 1 to 32 warps a sample");
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)n;
  if (is_u8) {
    samples_rounds_kernel<W, uint8_t, Skip><<<blocks, 32 * W, 0, s>>>(
        (const uint8_t*)dens, nx, ny, nz, seed, c, min_dist, pos_out, dir_out, found_out,
        work_out, sk);
  } else {
    samples_rounds_kernel<W, float, Skip><<<blocks, 32 * W, 0, s>>>(
        (const float*)dens, nx, ny, nz, seed, c, min_dist, pos_out, dir_out, found_out,
        work_out, sk);
  }
  return (int)cudaGetLastError();
}

// The face table of the cell jump's exit (kSkipCell) in the block's dynamic
// shared memory, filled once by the block's threads; with kSkipCellPow2 the
// faces by product.
template <int Skip>
__device__ __forceinline__ ds::CellExit<Skip> attempt_face_exit(int nx, int ny, int nz,
                                                                const ds::MarchConsts& c,
                                                                const ds::SkipArgs& sk) {
  extern __shared__ float attempt_faces[];
  if constexpr (Skip == ds::kSkipCell) {
    const int size = ds::face_table_size(nx, ny, nz);
    for (int i = threadIdx.x; i < size; i += blockDim.x) {
      attempt_faces[i] = ds::face_table_entry(i, nx, ny, nz, c.bbox);
    }
    __syncthreads();
  }
  return ds::face_exit_of<Skip == ds::kSkipCellPow2>(attempt_faces, nx, ny, c.bbox, c.step, sk);
}

// K7a with the cell jump (kSkipCell: the exit's faces from the face table;
// kSkipCellPow2: by product): a thread an attempt.  A group of A lanes takes
// sample (block * blockDim + thread) / A and makes its attempts in rounds
// of A, lane l making attempt first + l with attempt_chunk_jump, K steps a
// chunk, so that a jump costs no warp iteration.  The warp's lanes march
// chunk by chunk until every group's round is decided: its smallest
// accepted attempt found and every attempt below it ended (or every
// attempt ended); work past the winner is dropped.  The group sums the
// steps the serial loop counts (round_end's) by shuffles, and the winner's
// lane writes the sample (attempts = winner + 1).  Every lane runs the
// warp's ballots and shuffles with the full mask, at points where the
// whole warp is converged.
template <int A, int K, typename T, int Skip>
__global__ void __launch_bounds__(ds::kAttemptThreads) samples_threads_kernel(
    const T* __restrict__ dens, int nx, int ny, int nz, uint32_t seed, int64_t n,
    ds::MarchConsts c, float min_dist, float* __restrict__ pos_out, float* __restrict__ dir_out,
    uint8_t* __restrict__ found_out, int32_t* __restrict__ work_out, ds::SkipArgs sk) {
  static_assert(A == 4 || A == 8 || A == 16 || A == 32, "A: 4 to 32 attempts a round");
  constexpr unsigned kFull = 0xffffffffu;
  const ds::CellExit<Skip> jump = attempt_face_exit<Skip>(nx, ny, nz, c, sk);
  const int lane = threadIdx.x & 31;
  const int gl = lane & (A - 1);
  const int shift = lane - gl;
  const int64_t s = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / A;
  ds::Ray R;
  int steps = 0;  // the sample's steps so far (the same on its group's lanes)
  bool done = s >= n;  // the group's sample written (or none to make)
  for (int first = 0; first < ds::kMaxAttempts; first += A) {
    if (!__any_sync(kFull, !done)) break;
    const bool made = !done && first + gl < ds::kMaxAttempts;
    if (made) ds::attempt_start(R, ds::attempt_ray(seed, (uint32_t)s, first + gl, c, min_dist), c);
    bool marching = made && R.active;
    unsigned accepted, need;
    for (;;) {
      const unsigned ended = (__ballot_sync(kFull, !marching) >> shift) & ds::lanes_below(A);
      accepted = (__ballot_sync(kFull, made && !marching && ds::accepted(R, c)) >> shift) &
                 ds::lanes_below(A);
      need = accepted != 0u ? ds::lanes_below(ds::first_lane(accepted) + 1) : ds::lanes_below(A);
      const bool open = marching && (ended & need) != need;
      if (!__any_sync(kFull, open)) break;
      if (open) {
        ds::attempt_chunk_jump<K>(R, dens, nx, ny, nz, c, jump);
        marching = R.active;
      }
    }
    int counted = made && ((need >> gl) & 1u) ? R.steps : 0;
#pragma unroll
    for (int o = A / 2; o > 0; o >>= 1) counted += __shfl_xor_sync(kFull, counted, o);
    if (!done) {
      steps += counted;
      if (accepted != 0u) {
        const int winner = ds::first_lane(accepted);
        if (gl == winner) {
          ds::sample_end(s, true, R, c, first + winner + 1, steps, pos_out, dir_out, found_out,
                         work_out);
        }
        done = true;
      }
    }
  }
  if (!done && gl == 0) {
    ds::sample_end(s, false, R, c, ds::kMaxAttempts, steps, pos_out, dir_out, found_out,
                   work_out);
  }
}

// K7a with the cell jump at A attempts a group and lookahead K
// (samples_threads_kernel): Skip kSkipCell (the face table) or
// kSkipCellPow2.
template <int A, int K, int Skip>
static int samples_threads(const void* dens, int is_u8, int nx, int ny, int nz, uint32_t seed,
                           int64_t n, const ds::MarchConsts& c, float min_dist, float* pos_out,
                           float* dir_out, uint8_t* found_out, int32_t* work_out, cudaStream_t s,
                           const ds::SkipArgs& sk) {
  const int64_t threads = n * A;
  const int64_t blocks = (threads + ds::kAttemptThreads - 1) / ds::kAttemptThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem =
      Skip == ds::kSkipCell ? (size_t)ds::face_table_size(nx, ny, nz) * sizeof(float) : 0;
  if (smem > (size_t)ds::kMaxFaceTableBytes) return (int)cudaErrorInvalidValue;
  if (is_u8) {
    samples_threads_kernel<A, K, uint8_t, Skip><<<(unsigned)blocks, ds::kAttemptThreads, smem, s>>>(
        (const uint8_t*)dens, nx, ny, nz, seed, n, c, min_dist, pos_out, dir_out, found_out,
        work_out, sk);
  } else {
    samples_threads_kernel<A, K, float, Skip><<<(unsigned)blocks, ds::kAttemptThreads, smem, s>>>(
        (const float*)dens, nx, ny, nz, seed, n, c, min_dist, pos_out, dir_out, found_out,
        work_out, sk);
  }
  return (int)cudaGetLastError();
}

// consts: ds_march's 18 floats (bbox, cloud AABB, step, dm; the light and
// radiance entries are not read).  Outputs: pos_out,
// dir_out [n, 3] float32, found_out [n] uint8, work_out [n, 2] int32
// (attempts, march steps).  Returns the launch's CUDA error, or 0.
extern "C" int ds_samples(const void* dens, int is_u8, int nx, int ny, int nz, uint32_t seed,
                          int64_t n, const float* consts, int max_steps, float min_dist,
                          float* pos_out, float* dir_out, uint8_t* found_out,
                          int32_t* work_out, void* stream) {
  if (n <= 0) return 0;
  const ds::MarchConsts c = ds::march_consts(consts, max_steps, 0);
  return samples_rounds<ds::kSampleWarps>(dens, is_u8, nx, ny, nz, seed, n, c, min_dist, pos_out,
                                      dir_out, found_out, work_out, (cudaStream_t)stream);
}

// ds_samples with an empty-space skip (kSkipCell or kSkipBlock, the JAX
// package's sampler march takes either).  Returns cudaErrorInvalidValue for
// another skip.
extern "C" int ds_samples_skip(const void* dens, int is_u8, int nx, int ny, int nz,
                               uint32_t seed, int64_t n, const float* consts, int max_steps,
                               float min_dist, float* pos_out, float* dir_out,
                               uint8_t* found_out, int32_t* work_out, void* stream,
                               DS_SKIP_PARAMS) {
  if (n <= 0) return 0;
  const ds::MarchConsts c = ds::march_consts(consts, max_steps, 0);
  const cudaStream_t s = (cudaStream_t)stream;
  if (skip == ds::kSkipCell) {
    const ds::SkipArgs sk = ds::cell_recips(DS_SKIP_ARGS, nx, ny, nz, c.step);
    return ds::pow2_cells(nx, ny, nz)
               ? samples_threads<ds::kAttemptGroup, ds::kAttemptLookahead, ds::kSkipCellPow2>(
                     dens, is_u8, nx, ny, nz, seed, n, c, min_dist, pos_out, dir_out, found_out,
                     work_out, s, sk)
               : samples_threads<ds::kAttemptGroup, ds::kAttemptLookahead, ds::kSkipCell>(
                     dens, is_u8, nx, ny, nz, seed, n, c, min_dist, pos_out, dir_out, found_out,
                     work_out, s, sk);
  }
  if (skip == ds::kSkipBlock && occ != nullptr) {
    return samples_rounds<ds::kSampleWarps, ds::kSkipBlock>(dens, is_u8, nx, ny, nz, seed, n,
                                                            c, min_dist, pos_out, dir_out,
                                                            found_out, work_out, s,
                                                            DS_SKIP_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

// The warps a sample of ds_samples (kSampleWarps).
extern "C" int ds_sample_warps() { return ds::kSampleWarps; }

#endif  // DS_HOST_EMULATION
