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
// scatter); a slab's textures stay in L2.
//
// What bounds a phase (probes/march_variants.py --spatial-only, the PT
// cell's 512^2 subframe and 1024^2, H100 80GB HBM3 at 700 W; PERF.md): the
// first phase marches fresh rays, most of them the whole budget of 512
// steps (75.5 M steps at 512^2), and is bound by the steps' throughput;
// every later phase has few rays alive (80,345, 1,260, 121, 9 of 262,144)
// with skewed step counts, and is bound by its longest ray's chain of
// steps and scatters (each scatter waits for the step before it).  The
// first design, a thread a ray (csrc/spatial_first.cuh), took 4.71 ms for
// the subframe, 2.66 of it in the four late phases (5.5 % of the steps),
// at 0.6-2 us a serial step of the longest ray.
// The design here, one launch a phase:
//   1. A persistent grid of groups of G lanes over the phase's rays: a
//      group without a ray scans the next rays (one atomicAdd a warp, K4's
//      refill; a dead ray's record settled at once, an alive one held) and
//      marches one at a time.  rec_in is first copied to rec_out, so a ray
//      that takes no step only zeroes its touched and steps.
//   2. G = 1 (a lane a ray, where most rays are alive: the first phase):
//      K4's march_steps at kLookahead under the slab's stop rule (SlabStop:
//      the budget, the ownership test), 16 chunks between refills: a
//      refill's warp votes wait for every lane, and at a refill every
//      chunk the queue lost to a thread a ray (5.30 against 4.09 ms at
//      1024^2's first phase; 4.07 at 16 chunks).
//   3. G = 8, 16 or 32 (ds_spatial_lanes, from the alive count): lane l
//      takes step c G + l of chunk c, its position the chain of additions
//      from the chunk's start (slab_lane), T the factors' products in step
//      order (chunk_trans), the first park, crossing or end by ballot,
//      the crossing's scatter K4's own (every lane of the group runs it on
//      the same values, so no state is shuffled back); 4 chunks between
//      refills.  A group scans about one alive ray at a time (ds_spatial_
//      scan), in an order spread over the image (scan_ray): the late
//      phases' rays cluster (in order: 3.23 ms for the subframe).  Lanes
//      took the late phases from 2.66 to 1.29 ms at 512^2.
// Every value equals the first design's bitwise: the same chains of
// additions and products, K4's functions, -fmad=false.  The subframe:
// 2.99 ms at 512^2 (first design 4.71, K4 3.35 for the same samples), 6.51
// at 1024^2 (8.47, K4 7.48).
#include "lanes.cuh"
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

// Threads a block; the multiplier that spreads a lane group's scan over
// the rays ((item * kSpread) mod n, a bijection of [0, n) for n < kSpread:
// kSpread is prime).
constexpr int kSpatialThreads = 128;
constexpr uint64_t kSpread = 2654435761ull;
// The chunks a group marches between refills (a refill's warp votes wait
// for every group of the warp): 16 lookahead chunks at one lane a ray, 4
// chunks of G steps with G lanes (PERF.md).
constexpr int kSpatialChunks = 16;
constexpr int kSpatialLaneChunks = 4;
// The resident blocks a SM the kernel's launch bounds ask for: 1 leaves
// nvcc free to take 64 registers at one lane a ray (56 with the bound of
// threads alone): 1.69 against 1.83 ms at 512^2's first phase (PERF.md).
constexpr int kSpatialBlocks = 1;

// K9's stop rule (pathtrace.cuh::march_steps): before each step, the
// phase's budget of `budget` steps, then the ownership of the step's
// sample cell (its lower z corner in the whole grid), as phase_ray tests
// them; either parks the ray.
struct SlabStop {
  static constexpr int kState = kParked;
  int budget, nz, z0, slab;
  __device__ __forceinline__ bool operator()(int steps, float uz) const {
    if (steps >= budget) return true;
    const int cz = axis_cell(uz * (float)nz - 0.5f, nz).i0;
    return cz < z0 || cz >= z0 + slab;
  }
};

// A launch's inputs (ds_spatial_phase's arguments).
template <typename T>
struct SlabArgs {
  const T* dens;
  const T* insc;
  int nx, ny, nz;
  SlabZ zm;
  SlabStop stop;
  const float* eval_rows;
  const float* inv;
  PtConsts c;
  uint32_t seed;
  const int64_t* ids;
  int64_t n;
  int scan;  // the rays a group scans at a time (1 .. its lanes)
  int chunks;   // chunks a group marches a warp iteration (between refills)
  const float* rec_in;
  float* rec_out;
  // [0] the scan's head (zeroed before the launch); [1] the warps' march
  // iterations (a chunk of every group that has a ray), added once a warp.
  unsigned long long* counters;
};

// Quarter q (floats 4q .. 4q + 3) of a record.
__device__ __forceinline__ void load_quarter(const float* __restrict__ p, int q, float* v) {
#ifdef DS_HOST_EMULATION
  for (int k = 0; k < 4; ++k) v[k] = p[4 * q + k];
#else
  const float4 x = reinterpret_cast<const float4*>(p)[q];
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
#endif
}

__device__ __forceinline__ void store_quarter(float* __restrict__ p, int q, const float* v) {
#ifdef DS_HOST_EMULATION
  for (int k = 0; k < 4; ++k) p[4 * q + k] = v[k];
#else
  reinterpret_cast<float4*>(p)[q] = make_float4(v[0], v[1], v[2], v[3]);
#endif
}

// A launch first copies rec_in to rec_out (ds_spatial_phase); a ray that
// takes no step keeps that copy with touched and steps zeroed.
template <typename T>
__device__ __forceinline__ void clear_touched(const SlabArgs<T>& a, int64_t r) {
  float* p = a.rec_out + r * kWidth + kTouched;
#ifdef DS_HOST_EMULATION
  p[0] = 0.0f;
  p[1] = 0.0f;
#else
  *reinterpret_cast<float2*>(p) = make_float2(0.0f, 0.0f);
#endif
}

// Whether ray r is alive, from its record's last quarter (depth, alive,
// touched, steps); a dead ray's copy gets touched and steps zeroed where
// they are not.
template <typename T>
__device__ __forceinline__ bool scan_record(const SlabArgs<T>& a, int64_t r) {
  float v[4];
  load_quarter(a.rec_in + r * kWidth, kAlive / 4, v);
  if (v[kAlive % 4] != 0.0f) return true;
  if (v[kTouched % 4] != 0.0f || v[kSteps % 4] != 0.0f) clear_touched(a, r);
  return false;
}

// Ray r's sample at the phase's start: begun where the record is fresh
// (depth 0: begin_sample, as every rank does, before the ownership test),
// else from the record; its steps count this phase's.
template <typename T>
__device__ __forceinline__ void begin_ray(Sample& S, const SlabArgs<T>& a, int64_t r) {
  float v[kWidth];
#pragma unroll
  for (int q = 0; q < 4; ++q) load_quarter(a.rec_in + r * kWidth, q, v + 4 * q);
  const uint32_t id = (uint32_t)a.ids[r];
  if (v[kDepth] == 0.0f) {
    begin_sample(S, a.c, a.inv, a.seed, id, v[kPos], v[kPos + 1], v[kPos + 2], v[kDir],
                 v[kDir + 1], v[kDir + 2]);
    return;
  }
  S.px = v[kPos];
  S.py = v[kPos + 1];
  S.pz = v[kPos + 2];
  S.dx = v[kDir];
  S.dy = v[kDir + 1];
  S.dz = v[kDir + 2];
  S.trans = v[kTrans];
  S.od = v[kOd];
  S.weight = v[kWeight];
  for (int i = 0; i < 3; ++i) S.rad[i] = v[kRad + i];
  S.seed = a.seed;
  S.id = id;
  S.depth = (int)v[kDepth];
  S.steps = 0;
  S.bounces = 0;
}

// Ray r's record after its phase (state kEnded, or kParked: it goes on),
// the quarters q with q mod G == gl: lane gl of a group of G writes them
// (every lane holds the same S).  Only the owner writes: a ray that took
// no step keeps the copy of its record (a fresh ray stays fresh).
template <typename T>
__device__ __forceinline__ void finish_ray(const Sample& S, const SlabArgs<T>& a, int64_t r,
                                           int state, int gl, int G) {
  if (S.steps == 0) {
    if (gl == 0) clear_touched(a, r);
    return;
  }
  const float v[kWidth] = {S.px, S.py, S.pz, S.dx, S.dy, S.dz, S.trans, S.od, S.weight,
                           S.rad[0], S.rad[1], S.rad[2], (float)S.depth,
                           state == kEnded ? 0.0f : 1.0f, 1.0f, (float)S.steps};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q % G == gl) store_quarter(a.rec_out + r * kWidth, q, v + 4 * q);
  }
}

// A lane of one thread: kLookahead steps of K4's march_steps under the
// slab's stop rule, then the crossing's scatter → kMarching, kParked or
// kEnded.
template <typename T>
__device__ __forceinline__ int march_lookahead(Sample& S, const SlabArgs<T>& a) {
  Crossing X;
  const int state = march_steps<kLookahead>(S, X, a.dens, a.nx, a.ny, a.nz, a.c, a.zm, a.stop);
  if (state != kCrossed) return state;
  return resolve(S, X, a.insc, a.nx, a.ny, a.nz, a.eval_rows, a.inv, a.c, a.zm) ? kEnded
                                                                                 : kMarching;
}

// Lane gl's step of a chunk of G steps from S: where it lands (gl + 1
// additions of dir * step to S's position, the serial loop's chain), the
// stop rule's state before it, its density and factor; tn (T after it)
// comes from chunk_trans.
struct SlabLane {
  float ax, ay, az;
  float density, e, tn;
  int stop;
};

template <int G, typename T>
__device__ __forceinline__ SlabLane slab_lane(const Sample& S, int gl, const SlabArgs<T>& a) {
  const PtConsts& c = a.c;
  SlabLane L;
  L.ax = S.px;
  L.ay = S.py;
  L.az = S.pz;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if (k <= gl) {
      L.ax = L.ax + S.dx * c.step;
      L.ay = L.ay + S.dy * c.step;
      L.az = L.az + S.dz * c.step;
    }
  }
  const float uz = div_exact(L.az, c.bbox[2], c.inv_bbox[2]);
  L.stop = a.stop(S.steps + gl, uz) ? kParked : kMarching;
  L.density = trilinear_strided(a.dens, a.nx, a.ny, a.nz, div_exact(L.ax, c.bbox[0], c.inv_bbox[0]),
                                div_exact(L.ay, c.bbox[1], c.inv_bbox[1]), uz, a.zm) *
              c.dm;
  L.e = expf(-L.density * c.step);
  L.tn = 0.0f;
  return L;
}

// T after lane gl's step: trans * e_0 * ... * e_gl in step order, e_of(k)
// lane k's factor (a shuffle on the card): the serial loop's products.
template <int G, class E>
__device__ __forceinline__ float chunk_trans(float trans, int gl, E e_of) {
  float t = trans;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const float ek = e_of(k);
    if (k <= gl) t = t * ek;
  }
  return t;
}

// What ends the chunk at lane L's step, if anything: the stop rule before
// it (kParked), a crossing (kCrossed), free_step's end (kEnded: the box
// exit, or the depth test), else kMarching.
__device__ __forceinline__ int lane_event(const Sample& S, const SlabLane& L, const PtConsts& c) {
  if (L.stop != kMarching) return L.stop;
  if (S.od > L.tn) return kCrossed;
  const bool ends = !in_box(L.ax, L.ay, L.az, c.bbox) || (!(c.flags & kSingle) && S.depth >= c.max_depth);
  return ends ? kEnded : kMarching;
}

// The chunk's effect on S, f the first lane with an event ev (G: none),
// at(k) lane k's SlabLane (shuffles on the card): the free steps before f,
// then f's event: a park, free_step's end, or the crossing's scatter (K4's
// own) → kMarching, kParked or kEnded.
template <class At, typename T>
__device__ __forceinline__ int chunk_apply(Sample& S, int f, int ev, At at, const SlabArgs<T>& a) {
  if (f > 0) {
    const SlabLane P = at(f - 1);
    S.px = P.ax;
    S.py = P.ay;
    S.pz = P.az;
    S.trans = P.tn;
  }
  S.steps += f;
  if (ev == kMarching || ev == kParked) return ev;
  const SlabLane X = at(f);
  ++S.steps;
  if (ev == kEnded) {
    free_step(S, a.c, X.ax, X.ay, X.az, X.tn);
    return kEnded;
  }
  return scatter(S, a.insc, a.nx, a.ny, a.nz, a.eval_rows, a.inv, a.c, X.ax, X.ay, X.az,
                 X.density, X.tn, a.zm)
             ? kEnded
             : kMarching;
}

// Item `item` of a phase's scan → its ray: in order, or (Spread) spread
// over the rays, so that the few alive rays of a late phase, which cluster
// in the image, fall to different groups.  The kernel spreads for G lanes
// a ray; with a lane a ray a warp's rays stay neighbours.
template <bool Spread>
__device__ __forceinline__ int64_t scan_ray(int64_t item, int64_t n) {
  if (!Spread) return item;
  return (int64_t)(((uint64_t)item * kSpread) % (uint64_t)n);
}

// Ray r's phase as a group of G lanes marches it, its lanes emulated one
// after the other (the host build's statement of the kernel's group; G = 1
// is a lane of one thread), rec_out holding rec_in's copy.
template <int G, typename T>
__device__ __forceinline__ void ray_phase(const SlabArgs<T>& a, int64_t r) {
  if (!scan_record(a, r)) return;
  Sample S;
  begin_ray(S, a, r);
  int state = kMarching;
  while (state == kMarching) {
    if (G == 1) {
      state = march_lookahead(S, a);
      continue;
    }
    SlabLane L[G];
    for (int gl = 0; gl < G; ++gl) L[gl] = slab_lane<G>(S, gl, a);
    for (int gl = 0; gl < G; ++gl) {
      L[gl].tn = chunk_trans<G>(S.trans, gl, [&](int k) { return L[k].e; });
    }
    int f = G, ev = kMarching;
    for (int gl = 0; gl < G && f == G; ++gl) {
      const int e = lane_event(S, L[gl], a.c);
      if (e != kMarching) {
        f = gl;
        ev = e;
      }
    }
    state = chunk_apply(S, f, ev, [&](int k) { return L[k]; }, a);
  }
  for (int gl = 0; gl < G; ++gl) finish_ray(S, a, r, state, gl, G);
}

}  // namespace spatial
}  // namespace ds

#ifndef DS_HOST_EMULATION

namespace ds {
namespace spatial {

constexpr unsigned kFull = 0xffffffffu;

// A group's chunk on the card: each lane its step, T by shuffled factors,
// the first event by ballot, lane f's values shuffled to the group.  Every
// shuffle names the group's own lanes only.
template <int G, typename T>
__device__ __forceinline__ int chunk_lanes(Sample& S, const GroupLanes& gr, const SlabArgs<T>& a) {
  SlabLane L = slab_lane<G>(S, gr.gl, a);
  L.tn = chunk_trans<G>(S.trans, gr.gl, [&](int k) { return __shfl_sync(gr.mask, L.e, k, G); });
  const int ev = lane_event(S, L, a.c);
  const unsigned bits = __ballot_sync(gr.mask, ev != kMarching) >> gr.shift;
  const int f = bits != 0u ? ds::diff::lowest_lane(bits) : G;
  const int evf = __shfl_sync(gr.mask, ev, f < G ? f : 0, G);
  return chunk_apply(
      S, f, f < G ? evf : kMarching,
      [&](int k) {
        SlabLane o;
        o.ax = __shfl_sync(gr.mask, L.ax, k, G);
        o.ay = __shfl_sync(gr.mask, L.ay, k, G);
        o.az = __shfl_sync(gr.mask, L.az, k, G);
        o.density = __shfl_sync(gr.mask, L.density, k, G);
        o.e = 0.0f;
        o.tn = __shfl_sync(gr.mask, L.tn, k, G);
        o.stop = kMarching;
        return o;
      },
      a);
}

// The phase on a persistent grid: groups of G lanes, each marching one ray
// at a time.  A group without a ray takes one its lanes hold from the
// scan; else the groups without one scan a.scan rays each (one atomicAdd a
// warp, of every such group's share; the base shuffled), each of its first
// a.scan lanes one ray: a dead ray's copy is settled at once (touched and
// steps zeroed), an alive one held.  A lane of one thread (G = 1) takes
// its scanned ray at once: K4's refill.  A ray's group marches it a.chunks
// chunks a warp iteration (march_lookahead or chunk_lanes) until it parks
// or ends, writes its record and takes the next.
template <int G, bool Spread = (G > 1), typename T>
__device__ __forceinline__ void phase_items(const SlabArgs<T>& a) {
  const GroupLanes gr = group_lanes<G>();
  const int lane = threadIdx.x & 31;
  Sample S;
  int64_t ray = 0, held = -1;
  bool have = false, drained = false;
  unsigned long long iters = 0;
  for (;;) {
    for (;;) {
      if (!have) {
        const unsigned hb = __ballot_sync(gr.mask, held >= 0) >> gr.shift;
        if (hb != 0u) {
          const int src = ds::diff::lowest_lane(hb);
          ray = __shfl_sync(gr.mask, held, src, G);
          if (gr.gl == src) held = -1;
          begin_ray(S, a, ray);
          have = true;
        }
      }
      const bool need = !have && !drained;
      const unsigned want = __ballot_sync(kFull, need && gr.gl == 0);
      if (want == 0u) break;
      const int leader = __ffs(want) - 1;
      unsigned long long base = 0;
      if (lane == leader) {
        base = atomicAdd(&a.counters[0], (unsigned long long)__popc(want) * a.scan);
      }
      base = __shfl_sync(kFull, base, leader);
      if (need) {
        const int64_t first =
            (int64_t)(base + (unsigned long long)__popc(want & ((1u << gr.shift) - 1u)) * a.scan);
        const int64_t item = first + gr.gl;
        if (gr.gl < a.scan && item < a.n) {
          const int64_t r = scan_ray<Spread>(item, a.n);
          if (scan_record(a, r)) held = r;
        }
        drained = first + a.scan >= a.n;
      }
    }
    if (!__any_sync(kFull, have)) break;
    ++iters;
    if (have) {
      int state = kMarching;
      for (int t = 0; t < a.chunks && state == kMarching; ++t) {
        state = G == 1 ? march_lookahead(S, a) : chunk_lanes<G>(S, gr, a);
      }
      if (state != kMarching) {
        finish_ray(S, a, ray, state, gr.gl, G);
        have = false;
      }
    }
  }
  if (lane == 0) atomicAdd(&a.counters[1], iters);
}

}  // namespace spatial
}  // namespace ds

// K9's kernel: G lanes a ray; its launch bounds ask for kSpatialBlocks
// resident blocks a SM.
template <int G, typename T>
__global__ void __launch_bounds__(ds::spatial::kSpatialThreads, ds::spatial::kSpatialBlocks)
    spatial_items_kernel(ds::spatial::SlabArgs<T> a) {
  ds::spatial::phase_items<G>(a);
}

namespace {

// The card's thread slots (its SMs x 2048).
int64_t thread_slots() {
  static int64_t slots = 0;
  if (slots == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, device);
    slots = (int64_t)sms * per_sm > 0 ? (int64_t)sms * per_sm : 1;
  }
  return slots;
}

// The launch's arguments (ds_spatial_phase's).
template <typename T>
ds::spatial::SlabArgs<T> slab_args(const void* dens, const void* insc, int nx, int ny, int nz,
                                   int z0, int slab, int halo, const float* eval_rows,
                                   const float* inv_rows, const ds::PtConsts& c, uint32_t seed,
                                   const int64_t* ids, int64_t n, int scan, int chunks,
                                   int steps, const float* rec_in, float* rec_out,
                                   unsigned long long* counters) {
  ds::spatial::SlabArgs<T> a;
  a.dens = (const T*)dens;
  a.insc = (const T*)insc;
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.zm = ds::spatial::SlabZ{z0 - halo, slab + 2 * halo - 1};
  a.stop = ds::spatial::SlabStop{steps, nz, z0, slab};
  a.eval_rows = eval_rows;
  a.inv = inv_rows;
  a.c = c;
  a.seed = seed;
  a.ids = ids;
  a.n = n;
  a.scan = scan;
  a.chunks = chunks;
  a.rec_in = rec_in;
  a.rec_out = rec_out;
  a.counters = counters;
  return a;
}

// Zeroes the counters, copies rec_in to rec_out, then launches `kernel` (G
// lanes a ray) on a persistent grid: occupancy x SMs blocks, fewer where
// fewer groups scan the rays in one round.
template <typename A>
int launch_items(void (*kernel)(A), int G, int* per_sm, A a, cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(a.counters, 0, 2 * sizeof(unsigned long long), s);
  if (e == cudaSuccess) {
    e = cudaMemcpyAsync(a.rec_out, a.rec_in, a.n * ds::spatial::kWidth * sizeof(float),
                        cudaMemcpyDeviceToDevice, s);
  }
  if (e == cudaSuccess && *per_sm == 0) {
    int b = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, ds::spatial::kSpatialThreads, 0);
    *per_sm = b > 0 ? b : 1;
  }
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int64_t groups = (a.n + a.scan - 1) / a.scan;
  const int64_t needed =
      (groups * G + ds::spatial::kSpatialThreads - 1) / ds::spatial::kSpatialThreads;
  const int64_t full = (int64_t)*per_sm * sms;
  const unsigned blocks = (unsigned)(needed < full ? needed : full);
  void* args[] = {&a};
  return (int)cudaLaunchKernel((const void*)kernel, dim3(blocks),
                               dim3(ds::spatial::kSpatialThreads), args, 0, s);
}

template <int G, typename T>
int launch_lanes(const ds::spatial::SlabArgs<T>& a, cudaStream_t s) {
  static int per_sm = 0;
  return launch_items(spatial_items_kernel<G, T>, G, &per_sm, a, s);
}

template <typename T>
int launch_phase(int lanes, const ds::spatial::SlabArgs<T>& a, cudaStream_t s) {
  switch (lanes) {
    case 1: return launch_lanes<1>(a, s);
    case 4: return launch_lanes<4>(a, s);
    case 8: return launch_lanes<8>(a, s);
    case 16: return launch_lanes<16>(a, s);
    case 32: return launch_lanes<32>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K9's lanes a ray for a phase of n rays with n_alive alive (measured on
// the PT cell's subframe at 512^2 and 1024^2, probes/march_variants.py
// --spatial-only; PERF.md): 1 (K4's queue, a lane a ray) where most rays
// are alive, as in the first phase, whose fresh rays march far and bound
// it by the steps' throughput; else 8 from half the card's thread slots;
// 32 for fewer rays than a warp has lanes, where one ray's chain of steps
// and scatters bounds the phase; else 16.
extern "C" int ds_spatial_lanes(int64_t n, int64_t n_alive) {
  if (2 * n_alive >= n) return 1;
  if (2 * n_alive >= thread_slots()) return 8;
  return n_alive < 32 ? 32 : 16;
}

// The chunks a group of G lanes marches between refills.
extern "C" int ds_spatial_chunks(int G) {
  return G == 1 ? ds::spatial::kSpatialChunks : ds::spatial::kSpatialLaneChunks;
}

// The rays a group of G lanes scans at a time in a phase of n rays with
// n_alive alive: about one alive ray a scan (n / n_alive), 1 to G.
extern "C" int ds_spatial_scan(int64_t n, int64_t n_alive, int G) {
  const int64_t u = n_alive > 0 ? n / n_alive : G;
  return u < 1 ? 1 : (u > G ? G : (int)u);
}

// One phase over n rays, n_alive of them alive (it chooses the lanes a
// ray, ds_spatial_lanes).  dens, insc: the rank's slab [slab + 2 halo, ny,
// nx] of the [nz, ny, nx] grids (uint8 where is_u8, else float32); consts
// and ground as ds_pathtrace's; seed: the subframe's seed; rec_in /
// rec_out: [n, 16] records (not aliased, 16-byte aligned); counters: 2
// uint64, zeroed here, then the scan's head and the warps' march
// iterations.
extern "C" int ds_spatial_phase(const void* dens, const void* insc, int is_u8, int nx,
                                int ny, int nz, int z0, int slab, int halo,
                                const float* eval_rows, int n_phase, const float* inv_rows,
                                int n_inv, const float* consts, const float* ground,
                                int max_depth, int rr_start, int flags, uint32_t seed,
                                const int64_t* ids, int64_t n, int64_t n_alive, int steps,
                                const float* rec_in, float* rec_out,
                                unsigned long long* counters, void* stream) {
  if (n <= 0) return 0;
  const ds::PtConsts c =
      ds::pt_consts(consts, ground, 0, max_depth, rr_start, n_phase, n_inv, flags);
  const int lanes = ds_spatial_lanes(n, n_alive);
  const int scan = ds_spatial_scan(n, n_alive, lanes);
  const int chunks = ds_spatial_chunks(lanes);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_u8) {
    return launch_phase(lanes, slab_args<uint8_t>(dens, insc, nx, ny, nz, z0, slab, halo,
                                                  eval_rows, inv_rows, c, seed, ids, n, scan,
                                                  chunks, steps, rec_in, rec_out, counters),
                        s);
  }
  return launch_phase(lanes, slab_args<float>(dens, insc, nx, ny, nz, z0, slab, halo, eval_rows,
                                              inv_rows, c, seed, ids, n, scan, chunks, steps,
                                              rec_in, rec_out, counters),
                      s);
}

// The registers a thread of K9 at `lanes` lanes a ray on uint8 textures
// takes, or -1.
extern "C" int ds_spatial_registers(int lanes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaErrorInvalidValue;
  switch (lanes) {
    case 1: e = cudaFuncGetAttributes(&a, spatial_items_kernel<1, uint8_t>); break;
    case 4: e = cudaFuncGetAttributes(&a, spatial_items_kernel<4, uint8_t>); break;
    case 8: e = cudaFuncGetAttributes(&a, spatial_items_kernel<8, uint8_t>); break;
    case 16: e = cudaFuncGetAttributes(&a, spatial_items_kernel<16, uint8_t>); break;
    case 32: e = cudaFuncGetAttributes(&a, spatial_items_kernel<32, uint8_t>); break;
  }
  return e == cudaSuccess ? a.numRegs : -1;
}

#endif  // DS_HOST_EMULATION
