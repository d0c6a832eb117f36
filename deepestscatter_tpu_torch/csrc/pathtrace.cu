// K4: the path tracer's bounce loop, a persistent kernel whose warps take
// (pixel, sample) work items from a queue and march them kLookahead steps
// at a time.
//
// Replaces the XLA loops of deepestscatter_tpu/render/pathtracer.py::
// _scatter_loop_deferred (line 73) and _scatter_loop (line 671), as
// render_subframe, trace_hit_radiance and trace_tick_moments drive them,
// with the estimator of the oracle loop _scatter_loop (march_deferred=False,
// lines 671-845) and single scatter as trace_hit_radiance runs it
// (lines 956-972).
//
// Per pixel with hit[r] set, for sample k = 0 .. n_samples-1:
//   seed = seed_base ^ ((sub_first + k) * 0x9E3779B1)
//   the sample starts at the box entry; SUN_MULTIPLE_SCATTER first redraws
//   the direction around the pixel's ray (counters 0, 1); od is drawn at
//   counter 4 * depth (counter 0 for single scatter); then per step:
//   pos += dir * step, sigma = trilinear(density) * dm,
//   T *= exp(-sigma * step).  The first step with od > T scatters at
//   pos - dir * log(od / T) / sigma: inside the box it adds NEE (phase at
//   the cosine to the sun x baked sun T x sun solid-angle ratio x light x
//   weight; the full Mie phase at depth 1 of the all-scatter mode, else the
//   chopped phase) and draws the next direction (inverse-CDF cos theta at
//   counter +1, azimuth at +2, from_onb, normalize); optional roulette at
//   +3.  A sample ends on leaving the box (+-0.01 margin; with sample_sky
//   it then adds sky gradient + sun disc at depth 1, times the weight), at
//   max_depth bounces, by roulette, after its single scatter, or after
//   max_steps steps, where it is cut.  Every sample is folded into the
//   pixel's Welford triple in sample order (progressive.cu:17-27).
//   pathtrace_pixel below states this as a loop over one pixel's samples;
//   the kernel computes the same values in another order.
//
// K7b, the dataset collector's radiance experiments (ds_radiance below),
// is this estimator with a per-pixel experiment base: sample k of pixel r
// uses the seed seed_base ^ ((sub0[r] + k) * 0x9E3779B1) in uint32
// arithmetic (wrapping), where K4 has the scalar sub_first.  It replaces
// the XLA program of deepestscatter_tpu/data/collectors.py::
// _radiance_launch (lines 150-223) over render/pathtracer.py::
// _scatter_loop_deferred (line 73): each pixel is a (point, replica) lane
// of the collector, run in SUN_MULTIPLE_SCATTER for `launches` samples.
// Its traffic is not K4's: an update is 2,048 points x 10 replicas x 100
// experiments, each a multiply scattered path from inside the cloud (758 M
// steps, 36.3 M in-box scatters at the collector's operating point).  Its
// first design was K4's item queue with the base (pathtrace_items_kernel,
// kept as ds_radiance's design 0 in march_variants.cu): 27.0-28.8 ms an
// update on an H100 at 700 W, 27x its operation bound, SIMT efficiency of
// the march 0.862, yet ~3 lanes in the ~270-operation scatter branch that
// the warp runs in nearly every 2-step march iteration.
// The design here (radiance_items_kernel): the scatters are deferred in
// the warp.  A lane whose step crossed od parks at the crossing
// (march_steps); a warp step either marches every unparked lane or, once
// kParkAt of its live lanes are parked or none marches, resolves every
// parked crossing together (resolve_now, resolve).  Records and folds are
// K4's.  Its launch bounds name a minimum of kRadianceBlocks = 1 resident
// block: nvcc then gives the kernel 79 registers, where a bound of threads
// alone held it at 64.  Measured against the first design
// (probes/march_variants.py at the update's shape, in turns, H100 80GB
// HBM3 at 700 W): 21.4-21.6 ms against 27.1-27.4 at 20 parked lanes, 17.3
// crossings a resolve step, the march's SIMT efficiency 0.41; 22.8-23.0 at
// 18, 22.3-22.4 at 22, 23.6-23.8 at 16, 24.3-24.7 at 24, 24.3-24.5 at 8,
// 33.4-33.5 at 28.  Registers decide more than the parking: at 20 parked,
// 70 registers (7 blocks) take 25.1-25.3 ms, 64 (8 blocks) 27.7-27.8 and
// 48, 40, 32 (spilling) 37.5, 63.3, 144.6; at 64 registers the best park
// was 24 and won 0-3 %.  Lookahead 1 or 4 is slower (25.9-26.3, 23.9-24.4);
// a point-major item order (a warp's fresh lanes are experiments of one
// point) is within 2 % (21.1-21.4: only an experiment's first flight is
// shared).  The warp's time follows neither its march slots nor its
// scatter passes alone.
//
// The step lattice is the oracle's: no AABB jump.  The empty-space skips
// (csrc/skip.cuh) are instantiations of their own, K4's
// (pathtrace_items_kernel<K, T, Skip>, ds_pathtrace_skip) with the cell
// jump of the JAX package's deferred loop (render/pathtracer.py:277-292)
// or the block skip of its oracle loop (:772-787), K7b's with the cell
// jump; they move positions at the ulp, so the default (no skip) keeps
// every bitwise gate, and its instantiations compile to the SASS they had
// before the skips.  Float expressions follow the plain version
// (render/pathtracer.py::scatter_loop_plain) term by term; the build uses
// -fmad=false.
//
// The cell jump (march_steps_jump, skip.cuh::FaceExit) is a redesign.
// Its first design (march_steps_skip, kept in csrc/pathtrace_variants.cu)
// ended the lookahead chunk at every jump and took the exit by ten IEEE
// divisions: 6.44 ms a 256^3 tick against 4.99 without a skip, 36.3 ms a
// collector update against 20.9 (H100 80GB HBM3 at 700 W).  A probe that
// took its exits and discarded them cost as much (6.44 ms): at 256^3, where
// a cell spans 2 steps, the exit's arithmetic, not the chunk end, was the
// loss.  Here the jump stays inside the chunk (the first pass moves the
// later steps past it; the second applies it after the same step), the
// kernel takes two instantiations by the grid: kSkipCellPow2 where every
// cell count is a power of two, the faces ((c + 0.5) * (1 / n)) * b, and
// kSkipCell, the faces from a table in shared memory; the exit keeps the
// three divisions (bound - p) / d and takes t / step as a product.
// Records, folds, steps and jumps stay bitwise the first design's.
// Measured in turns with the first design (probes/march_variants.py
// --jump-only, same card): 4.58-4.61 ms at 256^3 (first 6.39-6.42, no skip
// 4.99-5.05), 3.32-3.38 at 64^3 (4.31-4.34, 3.55-3.56), 25.1-25.2 an update
// (36.2, 20.9-21.0); warp march iterations -22 % at 256^3.  One kernel that
// chose each face's rule at run time measured 3.5 % faster at 256^3 and 4 %
// slower on the collector's 258^3 grid than the two instantiations.
//
// The block skip (march_steps_block, instantiation kSkipBlock) is a
// redesign.  Its first design (march_steps_skip, kept in
// csrc/pathtrace_variants.cu) read the float32 occupancy at every step's
// start, a dependent load in the chain of every step, also in the deep
// walks inside the cloud where the dilated occupancy is always 1 (4.02 ms
// a 256^3 tick against 5.07 without a skip, 4.76 at 64^3 against 3.74;
// H100 80GB HBM3 at 700 W).  Here (a) a step that lands in a cell with a
// nonzero corner (the taps' empty test) certifies the next sure_steps
// plain steps (ops/march.py::block_sure_steps: 12 at 256^3, 48 at 64^3),
// for which the occupancy is not read, and (b) the occupancy is read as
// one bit a block (skip.cuh::BitBlocks: 4 KB at 256^3) from global
// memory; a copy of the bits in shared memory measured no faster (3.63 ms
// at 256^3 and 4.46-4.55 at 64^3 against 3.56 and 4.37 from global
// memory, H100 80GB HBM3 at 700 W).  Records, folds, steps and jumps stay
// bitwise the first design's.  Where the skip loses at 64^3 the reads are
// not the cause: a read's cube of occupied blocks cut the reads twelvefold
// and block indices as products spared their divisions, and neither moved
// the time (PERF.md section 6).
//
// Bound on the card: the density and in-scatter textures (16.7 MB each at
// 256^3 uint8) stay in the 50 MB L2; ~80 float operations a march step and
// ~300 an in-box scatter make the operation bound (0.198 ms for the 512^2,
// two-subframe tick at 256^3: 159.9 M steps, 1.70 M scatters).
//
// What held the first design back (one thread per pixel over its samples,
// 128-thread blocks, 72 registers; 6.105 ms a tick at 256^3 on an H100 at
// 700 W, 31x the bound):
//   - latency: each step was one dependent chain (position, three
//     divisions, cell math, eight int64-indexed taps, weighted sum, expf,
//     compare), at about 7 warps a scheduler, about 5x slower than its
//     issue rate;
//   - SIMT efficiency 0.76 (the tick's per-pixel step counts in groups of
//     32): a warp waited for its longest pixel (up to 3,403 steps a tick
//     against a mean of 743 over hit pixels).
// The design here:
//   1. Lookahead march (march_chunk): a free flight is walked K steps at a
//      time.  The density and exp(-sigma * step) of a step do
//      not depend on the step before; only T *= e and the od > T test
//      carry.  A first pass computes the chunk's K positions (the same
//      incremental pos + dir * step), taps and factors as K independent
//      chains; a second pass applies T *= e_k and the test in order.  The
//      first crossing takes its step's values and drops the rest of the
//      chunk, which counts only the steps taken; box exits and the step
//      cap cut it the same way.  Every value equals the step-by-step loop.
//   2. Persistent threads with lane regeneration (pathtrace_items_kernel):
//      the grid fills the card once (occupancy x SMs); a lane whose sample
//      ends takes the next (pixel, sample) item in the same warp step
//      (ballot, one atomicAdd of the popcount by the leader, shuffle of
//      the base).  Items are sample-major, pixel-minor, so a warp's fresh
//      first flights are neighbours.  A pixel without a box hit is skipped.
//   3. Fold in sample order: each sample writes radiance, steps and in-box
//      scatters to a per-sample record [n_samples, N]; a second small
//      launch over the pixels (fold_kernel) folds them in sample order
//      with the expressions of the per-pixel loop.  Chosen over folding in
//      the sample that completes a pixel: it needs no arrival counters or
//      fences and reads the records once, coalesced.  They take 20 bytes a
//      (pixel, sample): 10.5 MB for a 512^2 two-subframe tick, growing
//      linearly with the samples of one launch.
//   4. Index math in 32 bits (common.cuh::trilinear_strided): the cell's
//      base offset once a step, the taps at strides 1, nx and nx * ny.
//      The wrapper raises for textures of 2^31 elements or more.
// The texture layout stays [Z, Y, X].  Texture coordinates divide by bbox
// as a product where bbox is a power of two (common.cuh::div_exact; 1 in a
// cubic grid), which keeps every value.
// Measured (probes/march_variants.py, 256^3 tick, H100 at 700 W): the
// queue is ~10 % faster than one thread per pixel with the same march
// (5.15 against 5.70 ms at K = 1), at 56 registers against 64, although
// its SIMT efficiency is lower (0.73 against 0.76): a tick gives each of
// the ~150 k resident lanes only ~3 samples and the warps' last samples
// form a tail.  The 32-bit taps and exact divisions gave ~2 %.  In the
// queue K = 1 and K = 2 cannot be told apart from the noise of a run;
// K = 4 and 8 are slower (registers, spills, dropped steps): the loop is
// not bound by the latency of its chain.  K = 2 is kept.  Reading a uint8
// row's two x taps with one aligned 32-bit load was slower at every K: the
// march is not bound by its count of load instructions either.
#include "pathtrace.cuh"

#ifndef DS_HOST_EMULATION

constexpr int kPtThreads = 128;
constexpr unsigned kFullMask = 0xffffffffu;

// The cell jump's exit (skip.cuh::FaceExit) of the instantiation Skip:
// with kSkipCell the launch's face table (skip.cuh::face_table_entry) in the
// block's dynamic shared memory, filled once by the block's threads.
template <int Skip>
__device__ __forceinline__ ds::CellExit<Skip> shared_face_exit(int nx, int ny, int nz,
                                                               const ds::PtConsts& c,
                                                               const ds::SkipArgs& sk) {
  extern __shared__ float faces[];
  if constexpr (Skip == ds::kSkipCell) {
    const int size = ds::face_table_size(nx, ny, nz);
    for (int i = threadIdx.x; i < size; i += blockDim.x) {
      faces[i] = ds::face_table_entry(i, nx, ny, nz, c.bbox);
    }
    __syncthreads();
  }
  return ds::face_exit_of<Skip == ds::kSkipCellPow2>(faces, nx, ny, c.bbox, c.step, sk);
}

// The dynamic shared memory of a launch with skip Skip: the face table
// with kSkipCell, else none.
template <int Skip>
static size_t skip_shared_bytes(int nx, int ny, int nz) {
  return Skip == ds::kSkipCell ? (size_t)ds::face_table_size(nx, ny, nz) * sizeof(float) : 0;
}

// counters[0]: the item queue's head (zeroed before the launch);
// counters[1]: the warps' step slots (K a loop iteration), added once per
// warp at exit.
template <int K, typename T, int Skip = ds::kSkipNone>
__global__ void __launch_bounds__(kPtThreads) pathtrace_items_kernel(
    const T* __restrict__ dens, const T* __restrict__ insc, int nx, int ny, int nz,
    const float* __restrict__ eval_rows, const float* __restrict__ inv,
    const float* __restrict__ entry, const float* __restrict__ dirs,
    const uint8_t* __restrict__ hit, const int64_t* __restrict__ ray_ids, int64_t n,
    int64_t n_items, ds::PtConsts c, uint32_t seed_base, uint32_t sub_first,
    const uint32_t* __restrict__ sub0, float* __restrict__ rec_rad,
    int32_t* __restrict__ rec_work, unsigned long long* __restrict__ counters,
    ds::SkipArgs sk) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  ds::CellExit<Skip> jump{};
  if constexpr (ds::kCellJump<Skip>) jump = shared_face_exit<Skip>(nx, ny, nz, c, sk);
  ds::Sample S;
  int64_t item = 0;
  int sure = 0;  // the block skip's certain plain steps (march_steps_block)
  bool have = false, drained = false;
  unsigned long long iters = 0;
  for (;;) {
    // Lanes without a sample take the next items, one atomicAdd a warp.
    for (;;) {
      const bool need = !have && !drained;
      const unsigned want = __ballot_sync(kFullMask, need);
      if (want == 0u) break;
      const int leader = __ffs(want) - 1;
      unsigned long long base = 0;
      if (lane == leader) base = atomicAdd(&counters[0], (unsigned long long)__popc(want));
      base = __shfl_sync(kFullMask, base, leader);
      if (need) {
        item = (int64_t)(base + (unsigned long long)__popc(want & below));
        if (item >= n_items) {
          drained = true;
        } else {
          have = ds::begin_item(S, item, n, entry, dirs, hit, ray_ids, inv, c, seed_base,
                                sub_first, sub0, rec_rad, rec_work);
          if constexpr (Skip != ds::kSkipNone) S.jumped = 0;
          if constexpr (Skip == ds::kSkipBlock) sure = 0;
        }
      }
    }
    if (!__any_sync(kFullMask, have)) break;
    ++iters;
    if constexpr (Skip == ds::kSkipNone) {
      if (have && ds::march_chunk<K>(S, dens, insc, nx, ny, nz, eval_rows, inv, c)) {
        ds::write_record(S, item, rec_rad, rec_work);
        have = false;
      }
    } else if constexpr (ds::kCellJump<Skip>) {
      if (have && ds::march_chunk_jump<K>(S, dens, insc, nx, ny, nz, eval_rows, inv, c, jump)) {
        ds::write_record(S, item, rec_rad, rec_work);
        ds::add_jumped<Skip>(sk, item, n, S);
        have = false;
      }
    } else if (have && ds::march_chunk_block<K>(S, dens, insc, nx, ny, nz, eval_rows, inv, c,
                                                 ds::bit_blocks(sk), sk.sure_steps, sure)) {
      ds::write_record(S, item, rec_rad, rec_work);
      ds::add_jumped<Skip>(sk, item, n, S);
      have = false;
    }
  }
  if (lane == 0) atomicAdd(&counters[1], iters * K);
}

// K7b's queue: pathtrace_items_kernel's refill, with the scatters
// deferred.  A lane whose step crossed od parks there (march_steps); each
// warp step either marches every unparked lane or, once park_at lanes are
// parked or none marches, resolves every parked crossing together
// (resolve_now).  Items are sample-major, as K4's.  counters[1]: march
// slots (K a march step of the warp); counters[2]: the warps' resolve
// steps; counters[3]: the crossings they resolved.
template <int K, typename T, int Skip = ds::kSkipNone>
__global__ void __launch_bounds__(kPtThreads, ds::kRadianceBlocks) radiance_items_kernel(
    const T* __restrict__ dens, const T* __restrict__ insc, int nx, int ny, int nz,
    const float* __restrict__ eval_rows, const float* __restrict__ inv,
    const float* __restrict__ entry, const float* __restrict__ dirs,
    const uint8_t* __restrict__ hit, const int64_t* __restrict__ ray_ids, int64_t n,
    int n_samples, ds::PtConsts c, uint32_t seed_base, const uint32_t* __restrict__ sub0,
    int park_at, float* __restrict__ rec_rad, int32_t* __restrict__ rec_work,
    unsigned long long* __restrict__ counters, ds::SkipArgs sk) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int64_t n_items = n * (int64_t)n_samples;
  ds::CellExit<Skip> jump{};
  if constexpr (ds::kCellJump<Skip>) jump = shared_face_exit<Skip>(nx, ny, nz, c, sk);
  ds::Sample S;
  ds::Crossing X;
  int64_t item = 0;
  bool have = false, parked = false, drained = false;
  unsigned long long iters = 0, resolves = 0, resolved = 0;
  for (;;) {
    for (;;) {
      const bool need = !have && !drained;
      const unsigned want = __ballot_sync(kFullMask, need);
      if (want == 0u) break;
      const int leader = __ffs(want) - 1;
      unsigned long long base = 0;
      if (lane == leader) base = atomicAdd(&counters[0], (unsigned long long)__popc(want));
      base = __shfl_sync(kFullMask, base, leader);
      if (need) {
        item = (int64_t)(base + (unsigned long long)__popc(want & below));
        if (item >= n_items) {
          drained = true;
        } else {
          have = ds::begin_item(S, item, n, entry, dirs, hit, ray_ids, inv, c, seed_base, 0u,
                                sub0, rec_rad, rec_work);
          if constexpr (Skip != ds::kSkipNone) S.jumped = 0;
        }
      }
    }
    const unsigned live = __ballot_sync(kFullMask, have);
    if (live == 0u) break;
    const int n_parked = __popc(__ballot_sync(kFullMask, parked));
    if (ds::resolve_now(n_parked, __popc(live), park_at)) {
      ++resolves;
      resolved += (unsigned long long)n_parked;
      if (parked) {
        parked = false;
        if (ds::resolve(S, X, insc, nx, ny, nz, eval_rows, inv, c)) {
          ds::write_record(S, item, rec_rad, rec_work);
          ds::add_jumped<Skip>(sk, item, n, S);
          have = false;
        }
      }
    } else {
      ++iters;
      if (have && !parked) {
        const int state = ds::march_steps_any<K, Skip>(S, X, dens, nx, ny, nz, c, sk, jump);
        if (state == ds::kEnded) {
          ds::write_record(S, item, rec_rad, rec_work);
          ds::add_jumped<Skip>(sk, item, n, S);
          have = false;
        } else if (state == ds::kCrossed) {
          parked = true;
        }
      }
    }
  }
  if (lane == 0) {
    atomicAdd(&counters[1], iters * K);
    atomicAdd(&counters[2], resolves);
    atomicAdd(&counters[3], resolved);
  }
}

__global__ void __launch_bounds__(256) fold_kernel(
    const uint8_t* __restrict__ hit, int64_t n, int n_samples,
    const float* __restrict__ rec_rad, const int32_t* __restrict__ rec_work,
    float* __restrict__ mean_out, float* __restrict__ m2_out,
    float* __restrict__ count_out, int64_t* __restrict__ work_out) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  ds::fold_pixel(r, n, n_samples, hit, rec_rad, rec_work, mean_out, m2_out, count_out,
                 work_out);
}

template <int K, typename T, int Skip = ds::kSkipNone>
static int launch_items(const T* dens, const T* insc, int nx, int ny, int nz,
                        const float* eval_rows, const float* inv, const float* entry,
                        const float* dirs, const uint8_t* hit, const int64_t* ray_ids,
                        int64_t n, int64_t n_items, const ds::PtConsts& c,
                        uint32_t seed_base, uint32_t sub_first, const uint32_t* sub0,
                        float* rec_rad, int32_t* rec_work, unsigned long long* counters,
                        cudaStream_t s, const ds::SkipArgs& sk = ds::SkipArgs()) {
  const size_t smem = skip_shared_bytes<Skip>(nx, ny, nz);
  static int per_sm = 0;  // resident blocks a SM at per_sm_smem bytes of shared memory
  static size_t per_sm_smem = 0;
  if (per_sm == 0 || per_sm_smem != smem) {
    int b = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, pathtrace_items_kernel<K, T, Skip>, kPtThreads, smem);
    if (e != cudaSuccess) return (int)e;
    per_sm = b > 0 ? b : 1;
    per_sm_smem = smem;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int64_t needed = (n_items + kPtThreads - 1) / kPtThreads;
  const int64_t full = (int64_t)per_sm * sms;
  const unsigned blocks = (unsigned)(needed < full ? needed : full);
  pathtrace_items_kernel<K, T, Skip><<<blocks, kPtThreads, smem, s>>>(
      dens, insc, nx, ny, nz, eval_rows, inv, entry, dirs, hit, ray_ids, n, n_items, c,
      seed_base, sub_first, sub0, rec_rad, rec_work, counters, sk);
  return (int)cudaGetLastError();
}

// The item kernel at lookahead K, then the fold (ds_pathtrace's arguments).
template <int K, int Skip = ds::kSkipNone>
static int pathtrace_queue(const void* dens, const void* insc, int is_u8, int nx, int ny,
                           int nz, const float* eval_rows, int n_phase, const float* inv_rows,
                           int n_inv, const float* entry, const float* dirs,
                           const uint8_t* hit, const int64_t* ray_ids, int64_t n,
                           const float* consts, const float* ground, int max_steps,
                           int max_depth, int rr_start, int flags, uint32_t seed_base,
                           uint32_t sub_first, int n_samples, float* rec_rad,
                           int32_t* rec_work, unsigned long long* counters, float* mean_out,
                           float* m2_out, float* count_out, int64_t* work_out,
                           void* stream, const uint32_t* sub0 = nullptr,
                           const ds::SkipArgs& sk = ds::SkipArgs()) {
  if (n <= 0) return 0;
  const ds::PtConsts c =
      ds::pt_consts(consts, ground, max_steps, max_depth, rr_start, n_phase, n_inv, flags);
  const int64_t n_items = n * (int64_t)n_samples;
  cudaStream_t s = (cudaStream_t)stream;
  int err = (int)cudaMemsetAsync(counters, 0, 4 * sizeof(unsigned long long), s);
  if (err != 0) return err;
  if (Skip != ds::kSkipNone) {
    err = (int)cudaMemsetAsync(sk.jumped, 0, n * sizeof(unsigned long long), s);
    if (err != 0) return err;
  }
  if (is_u8) {
    err = launch_items<K, uint8_t, Skip>((const uint8_t*)dens, (const uint8_t*)insc, nx, ny,
                                         nz, eval_rows, inv_rows, entry, dirs, hit, ray_ids, n,
                                         n_items, c, seed_base, sub_first, sub0, rec_rad,
                                         rec_work, counters, s, sk);
  } else {
    err = launch_items<K, float, Skip>((const float*)dens, (const float*)insc, nx, ny, nz,
                                       eval_rows, inv_rows, entry, dirs, hit, ray_ids, n,
                                       n_items, c, seed_base, sub_first, sub0, rec_rad,
                                       rec_work, counters, s, sk);
  }
  if (err != 0) return err;
  fold_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      hit, n, n_samples, rec_rad, rec_work, mean_out, m2_out, count_out, work_out);
  return (int)cudaGetLastError();
}

// flags: 1 single scatter, 2 redraw the first direction per sample,
// 4 chopped phase at depth 1, 8 sample sky at box exits.  rec_rad
// [n_samples, n, 3] float32 and rec_work [n_samples, n, 2] int32 are the
// per-sample records; counters is 4 uint64 (zeroed here; K4 fills the
// queue head and the march slots); work_out is
// [n, 2] int64 (steps, in-box scatters).  Returns the first CUDA error of
// the two launches, or 0.
extern "C" int ds_pathtrace(const void* dens, const void* insc, int is_u8, int nx,
                            int ny, int nz, const float* eval_rows, int n_phase,
                            const float* inv_rows, int n_inv, const float* entry,
                            const float* dirs, const uint8_t* hit,
                            const int64_t* ray_ids, int64_t n, const float* consts,
                            const float* ground, int max_steps, int max_depth,
                            int rr_start, int flags, uint32_t seed_base,
                            uint32_t sub_first, int n_samples, float* rec_rad,
                            int32_t* rec_work, unsigned long long* counters,
                            float* mean_out, float* m2_out, float* count_out,
                            int64_t* work_out, void* stream) {
  return pathtrace_queue<ds::kLookahead>(
      dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase, inv_rows, n_inv, entry, dirs, hit,
      ray_ids, n, consts, ground, max_steps, max_depth, rr_start, flags, seed_base,
      sub_first, n_samples, rec_rad, rec_work, counters, mean_out, m2_out, count_out,
      work_out, stream);
}

// K7b's items at lookahead K, then the fold (ds_radiance's arguments).
template <int K, int Skip = ds::kSkipNone>
static int radiance_queue(const void* dens, const void* insc, int is_u8, int nx, int ny,
                          int nz, const float* eval_rows, int n_phase, const float* inv_rows,
                          int n_inv, const float* entry, const float* dirs,
                          const uint8_t* hit, const int64_t* ray_ids, int64_t n,
                          const float* consts, const float* ground, int max_steps,
                          int max_depth, int rr_start, int flags, uint32_t seed_base,
                          const uint32_t* sub0, int n_samples, int park_at, float* rec_rad,
                          int32_t* rec_work, unsigned long long* counters, float* mean_out,
                          float* m2_out, float* count_out, int64_t* work_out, void* stream,
                          const ds::SkipArgs& sk = ds::SkipArgs()) {
  if (n <= 0) return 0;
  if (sub0 == nullptr || park_at < 1 || park_at > 32) return (int)cudaErrorInvalidValue;
  const ds::PtConsts c =
      ds::pt_consts(consts, ground, max_steps, max_depth, rr_start, n_phase, n_inv, flags);
  cudaStream_t s = (cudaStream_t)stream;
  int err = (int)cudaMemsetAsync(counters, 0, 4 * sizeof(unsigned long long), s);
  if (err != 0) return err;
  if (Skip != ds::kSkipNone) {
    err = (int)cudaMemsetAsync(sk.jumped, 0, n * sizeof(unsigned long long), s);
    if (err != 0) return err;
  }
  const size_t smem = skip_shared_bytes<Skip>(nx, ny, nz);
  // Resident blocks a SM, by texel type, at per_sm_smem bytes of shared memory.
  static int per_sm[2] = {0, 0};
  static size_t per_sm_smem[2] = {0, 0};
  int dev = 0, sms = 0;
  err = (int)cudaGetDevice(&dev);
  if (err == 0) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != 0) return err;
  int& resident = per_sm[is_u8 ? 1 : 0];
  if (resident == 0 || per_sm_smem[is_u8 ? 1 : 0] != smem) {
    err = is_u8 ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &resident, radiance_items_kernel<K, uint8_t, Skip>, kPtThreads, smem)
                : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      &resident, radiance_items_kernel<K, float, Skip>, kPtThreads, smem);
    if (err != 0) return err;
    if (resident < 1) resident = 1;
    per_sm_smem[is_u8 ? 1 : 0] = smem;
  }
  const int64_t needed = (n * (int64_t)n_samples + kPtThreads - 1) / kPtThreads;
  const int64_t full = (int64_t)resident * sms;
  const unsigned blocks = (unsigned)(needed < full ? needed : full);
  if (is_u8) {
    radiance_items_kernel<K, uint8_t, Skip><<<blocks, kPtThreads, smem, s>>>(
        (const uint8_t*)dens, (const uint8_t*)insc, nx, ny, nz, eval_rows, inv_rows, entry,
        dirs, hit, ray_ids, n, n_samples, c, seed_base, sub0, park_at, rec_rad, rec_work,
        counters, sk);
  } else {
    radiance_items_kernel<K, float, Skip><<<blocks, kPtThreads, smem, s>>>(
        (const float*)dens, (const float*)insc, nx, ny, nz, eval_rows, inv_rows, entry, dirs,
        hit, ray_ids, n, n_samples, c, seed_base, sub0, park_at, rec_rad, rec_work, counters,
        sk);
  }
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  fold_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      hit, n, n_samples, rec_rad, rec_work, mean_out, m2_out, count_out, work_out);
  return (int)cudaGetLastError();
}

// K7b: the radiance experiments, sample k of pixel r with the experiment
// base sub0[r] (uint32 [n]) in place of K4's sub_first, their scatters
// deferred in the warp (radiance_items_kernel at kParkAt, sample-major),
// then the fold.  The arguments are ds_pathtrace's; counters is 4 uint64
// (queue head, march slots, resolve steps, crossings resolved).
extern "C" int ds_radiance(const void* dens, const void* insc, int is_u8, int nx,
                           int ny, int nz, const float* eval_rows, int n_phase,
                           const float* inv_rows, int n_inv, const float* entry,
                           const float* dirs, const uint8_t* hit,
                           const int64_t* ray_ids, int64_t n, const float* consts,
                           const float* ground, int max_steps, int max_depth,
                           int rr_start, int flags, uint32_t seed_base,
                           const uint32_t* sub0, int n_samples, float* rec_rad,
                           int32_t* rec_work, unsigned long long* counters,
                           float* mean_out, float* m2_out, float* count_out,
                           int64_t* work_out, void* stream) {
  return radiance_queue<ds::kLookahead>(
      dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase, inv_rows, n_inv, entry, dirs, hit,
      ray_ids, n, consts, ground, max_steps, max_depth, rr_start, flags, seed_base, sub0,
      n_samples, ds::kParkAt, rec_rad, rec_work, counters, mean_out, m2_out, count_out,
      work_out, stream);
}

// ds_pathtrace with an empty-space skip (csrc/skip.cuh): kSkipCell or
// kSkipBlock; jumped is required, and with kSkipBlock the occupancy's bits.
// Returns cudaErrorInvalidValue for another skip.
extern "C" int ds_pathtrace_skip(const void* dens, const void* insc, int is_u8, int nx,
                                 int ny, int nz, const float* eval_rows, int n_phase,
                                 const float* inv_rows, int n_inv, const float* entry,
                                 const float* dirs, const uint8_t* hit,
                                 const int64_t* ray_ids, int64_t n, const float* consts,
                                 const float* ground, int max_steps, int max_depth,
                                 int rr_start, int flags, uint32_t seed_base,
                                 uint32_t sub_first, int n_samples, float* rec_rad,
                                 int32_t* rec_work, unsigned long long* counters,
                                 float* mean_out, float* m2_out, float* count_out,
                                 int64_t* work_out, void* stream, DS_SKIP_PARAMS) {
  const bool pow2 = ds::pow2_cells(nx, ny, nz);
  if (jumped == nullptr || (skip == ds::kSkipBlock && occ_bits == nullptr) ||
      (skip == ds::kSkipCell && !pow2 &&
       skip_shared_bytes<ds::kSkipCell>(nx, ny, nz) > (size_t)ds::kMaxFaceTableBytes)) {
    return (int)cudaErrorInvalidValue;
  }
#define DS_PT_QUEUE(SKIP)                                                                      \
  pathtrace_queue<ds::kLookahead, SKIP>(                                                       \
      dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase, inv_rows, n_inv, entry, dirs, hit,    \
      ray_ids, n, consts, ground, max_steps, max_depth, rr_start, flags, seed_base, sub_first, \
      n_samples, rec_rad, rec_work, counters, mean_out, m2_out, count_out, work_out, stream,   \
      nullptr, ds::cell_recips(DS_SKIP_ARGS, nx, ny, nz, consts[3]))
  if (skip == ds::kSkipCell) {
    return pow2 ? DS_PT_QUEUE(ds::kSkipCellPow2) : DS_PT_QUEUE(ds::kSkipCell);
  }
  if (skip == ds::kSkipBlock) return DS_PT_QUEUE(ds::kSkipBlock);
#undef DS_PT_QUEUE
  return (int)cudaErrorInvalidValue;
}

// ds_radiance with the empty-cell jump (skip kSkipCell, the collector's
// only skip); jumped is required.  Returns cudaErrorInvalidValue for
// another skip.
extern "C" int ds_radiance_skip(const void* dens, const void* insc, int is_u8, int nx,
                                int ny, int nz, const float* eval_rows, int n_phase,
                                const float* inv_rows, int n_inv, const float* entry,
                                const float* dirs, const uint8_t* hit,
                                const int64_t* ray_ids, int64_t n, const float* consts,
                                const float* ground, int max_steps, int max_depth,
                                int rr_start, int flags, uint32_t seed_base,
                                const uint32_t* sub0, int n_samples, float* rec_rad,
                                int32_t* rec_work, unsigned long long* counters,
                                float* mean_out, float* m2_out, float* count_out,
                                int64_t* work_out, void* stream, DS_SKIP_PARAMS) {
  const bool pow2 = ds::pow2_cells(nx, ny, nz);
  if (skip != ds::kSkipCell || jumped == nullptr ||
      (!pow2 && skip_shared_bytes<ds::kSkipCell>(nx, ny, nz) > (size_t)ds::kMaxFaceTableBytes)) {
    return (int)cudaErrorInvalidValue;
  }
#define DS_RADIANCE_QUEUE(SKIP)                                                                   \
  radiance_queue<ds::kLookahead, SKIP>(                                                          \
      dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase, inv_rows, n_inv, entry, dirs, hit,      \
      ray_ids, n, consts, ground, max_steps, max_depth, rr_start, flags, seed_base, sub0,        \
      n_samples, ds::kParkAt, rec_rad, rec_work, counters, mean_out, m2_out, count_out, work_out, \
      stream, ds::cell_recips(DS_SKIP_ARGS, nx, ny, nz, consts[3]))
  return pow2 ? DS_RADIANCE_QUEUE(ds::kSkipCellPow2) : DS_RADIANCE_QUEUE(ds::kSkipCell);
#undef DS_RADIANCE_QUEUE
}

// The lanes parked before ds_radiance's warps resolve (kParkAt).
extern "C" int ds_radiance_park_at() { return ds::kParkAt; }

// The registers a thread of K4's item kernel on float32 textures (the
// differentiable renderer's) takes, or -1.
extern "C" int ds_pathtrace_registers() {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, pathtrace_items_kernel<ds::kLookahead, float>) != cudaSuccess) {
    return -1;
  }
  return a.numRegs;
}

#endif  // DS_HOST_EMULATION
