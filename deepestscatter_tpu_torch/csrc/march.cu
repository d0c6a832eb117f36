// K1: the neural camera march, a group of lanes per ray taking its
// consecutive steps (8 lanes, four rays a warp).
//
// Replaces the XLA loop of deepestscatter_tpu/ops/march.py::
// next_scattering_event (lines 100-286) as render/neural.py::march_pass1 and
// march_pass2 call it (march_pipeline=True, stop_at_scatter=False, the
// cloud-AABB clip), with render/pathtracer.py::in_scattering(chopped=False)
// fused into the pass-2 epilogue.
//
// Per ray: jump to the cloud AABB on the step lattice (enter_k =
// floor(t_near / step), one jump pos + dir * (enter_k * step)); then step,
// sample, attenuate: cur += dir * step, sigma = trilinear(density) * dm,
// T *= exp(-sigma * step); the first step with od > T is the scatter,
// pulled back by log(od / T) / sigma; the loop ends when cur leaves the
// AABB.  Pass 1 uses od = 0 (never scatters) and gives the total T.  Pass 2
// uses od = 1 - u (1 - T_total), u = hash_uniform(seed, ray_id, 0); rays
// that do not scatter report the analytic box exit; ok = scattered &&
// in_box(pos); NEE = radiance * phase(cos to sun) * T_sun(pos) * ratio.
// march_ray below states this as a loop over one ray's steps; the kernel
// computes the same values with a group of lanes on consecutive steps.
//
// The step cap is max_march_steps steps.  The JAX loop caps iterations of
// up to march_substeps steps each, but a ray that starts inside the box
// needs at most ceil(sqrt(3)/step) + 2 steps, fewer than the cap, so
// neither cap binds and the values are the same.
//
// Bound on the card: the density texture (16.7 MB at 256^3 uint8) stays
// in the 50 MB L2; ~74 float operations a step and ~130 a ray make the
// operation bound (0.0532 ms for the 512 x 256 frame's two passes, about
// 48 M steps over 120,762 + ~100 k rays).
//
// What held the first design back (one thread per ray in 128-thread
// blocks; 1.481 ms for both passes on an H100 at 700 W, 28x the bound,
// about 5x slower than its ~0.3 ms of issue time):
//   - too few threads: each pass marches at most 120,762 rays, under half
//     of the card's 270,336 thread slots, in a single wave that ends with
//     its longest rays while fewer and fewer warps hide latency;
//   - a dependent chain a step (position, three divisions, int64 cell
//     math, eight taps, expf, compare), although only T *= e, the crossing
//     test and the position carry from one step to the next.
// The design here:
//   1. A group of G = kMarchLanes lanes marches one ray, lane l taking
//      step c * G + l of chunk c.  The grid is rays x G threads, so a pass
//      is ~1 M threads (~4 waves of the card's slots), and a ray without an
//      AABB hit leaves at once for its whole group.
//   2. Positions by the sequential chain (lane_step): lane l adds
//      dir * step to the chunk's start position l + 1 times, the same
//      additions in the same order as the loop; the chunk's last taken
//      position is shuffled to every lane and starts the next chunk.
//   3. The per-step work that does not carry (coordinates, 32-bit
//      trilinear taps, sigma, expf) runs on the G lanes at once; at 256^3
//      a step is half a voxel, so a chunk's taps share cache lines.
//   4. The transmittance chain in step order (lane_transmittance): every
//      lane multiplies T by the chunk's factors e_0 .. e_l, shuffled from
//      their lanes: the multiplies of the loop, in its order.
//   5. Exit, cap and crossing by ballot (chunk_end): the first lane whose
//      position leaves the AABB takes the ray's last step, the cap cuts
//      the chunk, and the first lane with od > T computes the scatter
//      point from its own density, T and position.  The march goes on to
//      the AABB exit, so T is the whole ray's in both passes.
//   6. Once a ray: the AABB clip, the lattice jump, od (ray_begin), and the
//      epilogue (ray_end: analytic exit, ok, NEE, stores) on the group's
//      first lane.
// G = 8, not a whole warp: the position chain and the T fold cost G
// dependent iterations a chunk, so their share of a step's issue grows with
// G.  Measured (probes/march_variants.py, both passes of the 512 x 256
// frame, H100 at 700 W): G = 4 0.84 ms, 8 0.60, 16 0.68, 32 0.97; one
// thread per ray 1.46.  Lane utilisation at G = 8 is 0.978 in pass 1 and
// 0.986 in pass 2.
// Index math is 32-bit (common.cuh::trilinear_strided; the wrapper raises
// for textures of 2^31 texels or more) and texture coordinates divide by
// bbox as a product where bbox is a power of two (div_exact).  Every value
// equals march_ray's bitwise.  The warps' lane-step slots (32 a loop
// iteration) and the steps are counted (one atomic a block), so lane
// utilisation = steps / slots.
//
// K7a (csrc/samples.cu) reuses these device functions: a ray from values
// (ray_start) and chunks that end at the first crossing (chunk_end's
// stop_at_cross), which marches to the scatter and no further.
//
// The block skip (ds_march_skip, march_lanes_kernel<G, T, kSkipBlock>; the
// JAX package's pipelined march takes it, ops/march.py:199-207, and drops
// the cell jump): a step from a point whose dilated occupancy block is
// empty is long_steps lattice steps long.  A chunk's steps are all of the
// kind of its first (lane_step_skip): lane l adds the chunk's step l + 1
// times, and the chunk ends before the first lane whose step would be of
// the other kind (chunk_end_skip), so every lane walks the additions of
// the step-by-step loop.  Both passes take the same long steps (the
// positions are geometric).  The cell jump (K7a) ends a chunk after its
// first lane in an empty cell; the group then jumps once (chunk_jump).
#pragma once

#include "common.cuh"
#include "skip.cuh"

namespace ds {

// Lanes a ray: the steps of one chunk (a power of two up to 32).
constexpr int kMarchLanes = 8;

struct MarchConsts {
  float bbox[3];
  float inv_bbox[3];  // pow2_recip(bbox): texture coordinates as products
  float lo[3];  // cloud AABB
  float hi[3];
  float step;
  float dm;  // density multiplier
  float light[3];  // light_dir (points from the sun)
  float radiance[3];
  float sun_ratio;
  int max_steps;
  int n_phase;
};

__device__ __forceinline__ bool in_aabb(float x, float y, float z, const MarchConsts& c) {
  return x >= c.lo[0] && x <= c.hi[0] && y >= c.lo[1] && y <= c.hi[1] && z >= c.lo[2] &&
         z <= c.hi[2];
}

__device__ __forceinline__ float safe_dir(float d) {
  return fabsf(d) > 1e-9f ? d : 1e-9f;
}

// One ray in flight.
struct Ray {
  float px, py, pz;  // entry point
  float dx, dy, dz;
  float sx, sy, sz;  // safe_dir(d)
  float od;  // optical distance (0 in pass 1)
  float cx, cy, cz;  // position after the steps taken
  float trans;
  float qx, qy, qz;  // scatter position
  int steps;
  bool active, scattered;
};

// A ray from the entry point p along d with optical distance od: its jump
// to the cloud AABB on the step lattice.
__device__ __forceinline__ void ray_start(Ray& R, float px, float py, float pz, float dx,
                                          float dy, float dz, float od, const MarchConsts& c) {
  R.px = px;
  R.py = py;
  R.pz = pz;
  R.dx = dx;
  R.dy = dy;
  R.dz = dz;
  R.od = od;
  R.sx = safe_dir(R.dx);
  R.sy = safe_dir(R.dy);
  R.sz = safe_dir(R.dz);
  const float tax = (c.lo[0] - R.px) / R.sx, tbx = (c.hi[0] - R.px) / R.sx;
  const float tay = (c.lo[1] - R.py) / R.sy, tby = (c.hi[1] - R.py) / R.sy;
  const float taz = (c.lo[2] - R.pz) / R.sz, tbz = (c.hi[2] - R.pz) / R.sz;
  const float t_near = fmaxf(
      fmaxf(fmaxf(fminf(tax, tbx), fminf(tay, tby)), fminf(taz, tbz)), 0.0f);
  const float t_far = fminf(fminf(fmaxf(tax, tbx), fmaxf(tay, tby)), fmaxf(taz, tbz));
  const bool hits = t_far > t_near;
  const float jump = (hits ? floorf(t_near / c.step) : 0.0f) * c.step;
  R.cx = R.px + R.dx * jump;
  R.cy = R.py + R.dy * jump;
  R.cz = R.pz + R.dz * jump;
  R.trans = 1.0f;
  R.qx = R.qy = R.qz = 0.0f;
  R.steps = 0;
  R.scattered = false;
  R.active = in_box(R.px, R.py, R.pz, c.bbox) && hits && c.max_steps > 0;
}

// Ray r's entry, od and jump to the cloud AABB on the step lattice.
__device__ __forceinline__ void ray_begin(Ray& R, int64_t r, const float* __restrict__ entry,
                                          const float* __restrict__ dirs,
                                          const int64_t* __restrict__ ray_ids,
                                          const float* __restrict__ trans_total,
                                          uint32_t seed, const MarchConsts& c) {
  float od = 0.0f;
  if (trans_total != nullptr) {
    const float u = hash_uniform(seed, (uint32_t)ray_ids[r], 0u);
    od = 1.0f - u * (1.0f - trans_total[r]);
  }
  ray_start(R, entry[3 * r], entry[3 * r + 1], entry[3 * r + 2], dirs[3 * r], dirs[3 * r + 1],
            dirs[3 * r + 2], od, c);
}

// Ray r's outputs: T; in pass 2 (pos_out set) the scatter point or the
// analytic box exit, ok and the NEE radiance.
template <typename T>
__device__ __forceinline__ void ray_end(const Ray& R, int64_t r, const T* __restrict__ insc,
                                        int nx, int ny, int nz,
                                        const float* __restrict__ eval_rows,
                                        const MarchConsts& c, float* __restrict__ t_out,
                                        float* __restrict__ pos_out,
                                        uint8_t* __restrict__ ok_out,
                                        float* __restrict__ direct_out) {
  t_out[r] = R.trans;
  if (pos_out == nullptr) return;  // pass 1: total transmittance only
  float qx = R.qx, qy = R.qy, qz = R.qz;
  if (!R.scattered) {  // analytic full-box exit
    const float fx = fmaxf((0.0f - R.px) / R.sx, (c.bbox[0] - R.px) / R.sx);
    const float fy = fmaxf((0.0f - R.py) / R.sy, (c.bbox[1] - R.py) / R.sy);
    const float fz = fmaxf((0.0f - R.pz) / R.sz, (c.bbox[2] - R.pz) / R.sz);
    const float t_exit = fminf(fminf(fx, fy), fz);
    qx = R.px + R.dx * t_exit;
    qy = R.py + R.dy * t_exit;
    qz = R.pz + R.dz * t_exit;
  }
  const bool ok = R.scattered && in_box(qx, qy, qz, c.bbox);
  float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
  if (ok) {
    const float cosl =
        ((-c.light[0]) * R.dx + (-c.light[1]) * R.dy) + (-c.light[2]) * R.dz;
    const float t = ((cosl + 1.0f) * 0.5f) * (float)c.n_phase - 0.5f;
    const float t0 = floorf(t);
    const float frac = t0 < 0.0f ? 0.0f : t - t0;
    int i0 = (int)fminf(fmaxf(t0, -1.0f), (float)c.n_phase);
    i0 = i0 < 0 ? 0 : (i0 > c.n_phase - 1 ? c.n_phase - 1 : i0);
    const float mie = eval_rows[4 * i0] * (1.0f - frac) + eval_rows[4 * i0 + 1] * frac;
    const float sun_t = trilinear_strided(insc, nx, ny, nz,
                                          div_exact(qx, c.bbox[0], c.inv_bbox[0]),
                                          div_exact(qy, c.bbox[1], c.inv_bbox[1]),
                                          div_exact(qz, c.bbox[2], c.inv_bbox[2]));
    const float scale = mie * sun_t * c.sun_ratio;
    d0 = c.radiance[0] * scale;
    d1 = c.radiance[1] * scale;
    d2 = c.radiance[2] * scale;
  }
  pos_out[3 * r] = qx;
  pos_out[3 * r + 1] = qy;
  pos_out[3 * r + 2] = qz;
  ok_out[r] = ok ? 1 : 0;
  direct_out[3 * r] = d0;
  direct_out[3 * r + 1] = d1;
  direct_out[3 * r + 2] = d2;
}

// The estimator as one loop over ray r's steps.
template <typename T>
__device__ __forceinline__ void march_ray(
    int64_t r, const T* __restrict__ dens, const T* __restrict__ insc, int nx, int ny,
    int nz, const float* __restrict__ eval_rows, const float* __restrict__ entry,
    const float* __restrict__ dirs, const int64_t* __restrict__ ray_ids,
    const float* __restrict__ trans_total, uint32_t seed, const MarchConsts& c,
    float* __restrict__ t_out, float* __restrict__ pos_out,
    uint8_t* __restrict__ ok_out, float* __restrict__ direct_out) {
  Ray R;
  ray_begin(R, r, entry, dirs, ray_ids, trans_total, seed, c);
  while (R.active) {
    const float ax = R.cx + R.dx * c.step, ay = R.cy + R.dy * c.step,
                az = R.cz + R.dz * c.step;
    const float density =
        trilinear(dens, nx, ny, nz, ax / c.bbox[0], ay / c.bbox[1], az / c.bbox[2]) *
        c.dm;
    const float tn = R.trans * expf(-density * c.step);
    if (!R.scattered && R.od > tn) {
      const float back =
          logf(fmaxf(R.od, 1e-20f) / fmaxf(tn, 1e-20f)) / fmaxf(density, 1e-10f);
      R.qx = ax - R.dx * back;
      R.qy = ay - R.dy * back;
      R.qz = az - R.dz * back;
      R.scattered = true;
    }
    R.trans = tn;
    R.cx = ax;
    R.cy = ay;
    R.cz = az;
    ++R.steps;
    R.active = in_aabb(R.cx, R.cy, R.cz, c) && R.steps < c.max_steps;
  }
  ray_end(R, r, insc, nx, ny, nz, eval_rows, c, t_out, pos_out, ok_out, direct_out);
}

// One lane's step of a chunk: where it lands, its density and attenuation
// factor, and (after lane_transmittance) T after it.
struct LaneStep {
  float ax, ay, az;
  float density;
  float e;
  float tn;
};

// Lane `lane`'s step of the chunk that starts at R's position: lane + 1
// additions of dir * step, then the step's density (32-bit taps) and
// exp(-sigma step).
template <int G, typename T>
__device__ __forceinline__ LaneStep lane_step(const Ray& R, int lane, const T* __restrict__ dens,
                                              int nx, int ny, int nz, const MarchConsts& c) {
  LaneStep S;
  S.ax = R.cx;
  S.ay = R.cy;
  S.az = R.cz;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if (k <= lane) {
      S.ax = S.ax + R.dx * c.step;
      S.ay = S.ay + R.dy * c.step;
      S.az = S.az + R.dz * c.step;
    }
  }
  const float ux = div_exact(S.ax, c.bbox[0], c.inv_bbox[0]);
  const float uy = div_exact(S.ay, c.bbox[1], c.inv_bbox[1]);
  const float uz = div_exact(S.az, c.bbox[2], c.inv_bbox[2]);
  S.density = trilinear_strided(dens, nx, ny, nz, ux, uy, uz) * c.dm;
  S.e = expf(-S.density * c.step);
  S.tn = 0.0f;
  return S;
}

// T after lane `lane`'s step: trans * e_0 * ... * e_lane in step order,
// e_of(k) giving lane k's factor (a shuffle on the card).
template <int G, class E>
__device__ __forceinline__ float lane_transmittance(float trans, int lane, E e_of) {
  float t = trans;
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const float ek = e_of(k);
    if (k <= lane) t = t * ek;
  }
  return t;
}

__device__ __forceinline__ unsigned lanes_below(int n) {
  return n >= 32 ? 0xffffffffu : (1u << n) - 1u;
}

__device__ __forceinline__ int first_lane(unsigned bits) {
#ifdef DS_HOST_EMULATION
  return __builtin_ctz(bits);
#else
  return __ffs(bits) - 1;
#endif
}

// A chunk's steps taken: n; the lane that crossed first (-1: none); and
// whether the ray's march ended.  Bit k of `leaves` is set where lane k's
// position lies outside the cloud AABB, of `crosses` where od > T after
// lane k's step; `room` steps remain before the cap.  With stop_at_cross
// the march ends at the crossing step (the JAX loop's stop_at_scatter).
struct ChunkEnd {
  int n;
  int cross;
  bool ended;
};

__device__ __forceinline__ ChunkEnd chunk_end(unsigned leaves, unsigned crosses, int room,
                                              int G, bool stop_at_cross = false) {
  ChunkEnd E;
  E.n = G < room ? G : room;
  E.ended = room <= G;
  const unsigned out = leaves & lanes_below(E.n);
  if (out != 0u) {
    E.n = first_lane(out) + 1;
    E.ended = true;
  }
  const unsigned cr = crosses & lanes_below(E.n);
  E.cross = cr != 0u ? first_lane(cr) : -1;
  if (stop_at_cross && E.cross >= 0) {
    E.n = E.cross + 1;
    E.ended = true;
  }
  return E;
}

// The chunk's effect on R, at(k) giving lane k's LaneStep (shuffles on the
// card): the crossing lane's scatter point, then the last taken step's
// position and T.
template <class At>
__device__ __forceinline__ void chunk_update(Ray& R, const ChunkEnd& E, At at) {
  if (E.cross >= 0) {
    const LaneStep X = at(E.cross);
    const float back =
        logf(fmaxf(R.od, 1e-20f) / fmaxf(X.tn, 1e-20f)) / fmaxf(X.density, 1e-10f);
    R.qx = X.ax - R.dx * back;
    R.qy = X.ay - R.dy * back;
    R.qz = X.az - R.dz * back;
    R.scattered = true;
  }
  const LaneStep L = at(E.n - 1);
  R.trans = L.tn;
  R.cx = L.ax;
  R.cy = L.ay;
  R.cz = L.az;
  R.steps += E.n;
  R.active = !E.ended;
}

// Lane flags of a chunk, the inputs of chunk_end's ballots.
__device__ __forceinline__ bool lane_leaves(const LaneStep& S, const MarchConsts& c) {
  return !in_aabb(S.ax, S.ay, S.az, c);
}

__device__ __forceinline__ bool lane_crosses(const Ray& R, const LaneStep& S) {
  return !R.scattered && R.od > S.tn;
}

// A lane's flags of a chunk with a skip (csrc/skip.cuh), the inputs of
// chunk_end_skip's ballots: `cut` where the lane's step is not of the
// chunk's kind (kSkipBlock: the chunk ends before it), `empty` where it
// stepped into a cell whose 8 corners are 0 (kSkipCell: the chunk ends
// after it, with a jump).
struct LaneSkip {
  bool cut;
  bool empty;
};

// lane_step with a skip.  kSkipBlock: the chunk's steps are all of the kind
// of its first, long where the occupancy block at R's position is empty
// (dir * (step * long_steps) each) or plain (dir * step); lane `lane` adds
// it lane + 1 times and is cut where the block at the point its step
// leaves (after `lane` additions) is of the other kind, as the
// step-by-step loop would then take the other step there.  kSkipCell: the
// plain steps, and whether the lane's cell is empty.
template <int G, int Skip, typename T>
__device__ __forceinline__ LaneStep lane_step_skip(const Ray& R, int lane,
                                                   const T* __restrict__ dens, int nx, int ny,
                                                   int nz, const MarchConsts& c,
                                                   const SkipArgs& sk, LaneSkip& F) {
  bool lng = false;
  float inc = c.step;
  if (Skip == kSkipBlock) {
    lng = block_empty(sk, nx, ny, nz, div_exact(R.cx, c.bbox[0], c.inv_bbox[0]),
                      div_exact(R.cy, c.bbox[1], c.inv_bbox[1]),
                      div_exact(R.cz, c.bbox[2], c.inv_bbox[2]));
    if (lng) inc = c.step * (float)sk.long_steps;
  }
  LaneStep S;
  S.ax = R.cx;
  S.ay = R.cy;
  S.az = R.cz;
  float px = R.cx, py = R.cy, pz = R.cz;  // where the lane's step starts
#pragma unroll
  for (int k = 0; k < G; ++k) {
    if (k <= lane) {
      px = S.ax;
      py = S.ay;
      pz = S.az;
      S.ax = S.ax + R.dx * inc;
      S.ay = S.ay + R.dy * inc;
      S.az = S.az + R.dz * inc;
    }
  }
  F.cut = Skip == kSkipBlock &&
          block_empty(sk, nx, ny, nz, div_exact(px, c.bbox[0], c.inv_bbox[0]),
                      div_exact(py, c.bbox[1], c.inv_bbox[1]),
                      div_exact(pz, c.bbox[2], c.inv_bbox[2])) != lng;
  float cmax;
  S.density = trilinear_strided_max(dens, nx, ny, nz, div_exact(S.ax, c.bbox[0], c.inv_bbox[0]),
                                    div_exact(S.ay, c.bbox[1], c.inv_bbox[1]),
                                    div_exact(S.az, c.bbox[2], c.inv_bbox[2]), cmax) *
              c.dm;
  F.empty = Skip == kSkipCell && cmax <= 0.0f;
  S.e = expf(-S.density * c.step);
  S.tn = 0.0f;
  return S;
}

// chunk_end with a skip: the chunk ends before its first cut lane and after
// its first lane in an empty cell (bits of `cuts` and `empties`), then as
// chunk_end.  `jump` is set where the march goes on from that empty cell's
// lane, the last taken: chunk_jump then moves the ray.
__device__ __forceinline__ ChunkEnd chunk_end_skip(unsigned leaves, unsigned crosses,
                                                   unsigned cuts, unsigned empties, int room,
                                                   int G, bool stop_at_cross, bool& jump) {
  int m = cuts != 0u ? first_lane(cuts) : G;
  const unsigned emp = empties & lanes_below(m);
  if (emp != 0u) m = first_lane(emp) + 1;
  const ChunkEnd E = chunk_end(leaves, crosses, room, m, stop_at_cross);
  jump = emp != 0u && !E.ended && E.n == m;
  return E;
}

// The empty-cell exit jump of a ray still marching after a step into an
// empty cell (ops/march.py::next_scattering_event's SKIP_CELL).
__device__ __forceinline__ void chunk_jump(Ray& R, int nx, int ny, int nz, const MarchConsts& c) {
  const float e = cell_exit_steps(nx, ny, nz, c.bbox, c.step,
                                  div_exact(R.cx, c.bbox[0], c.inv_bbox[0]),
                                  div_exact(R.cy, c.bbox[1], c.inv_bbox[1]),
                                  div_exact(R.cz, c.bbox[2], c.inv_bbox[2]), R.cx, R.cy, R.cz,
                                  R.dx, R.dy, R.dz, 0x7fffffff);
  if (e > 0.0f) {
    const float d = e * c.step;
    R.cx = R.cx + R.dx * d;
    R.cy = R.cy + R.dy * d;
    R.cz = R.cz + R.dz * d;
  }
}

inline MarchConsts march_consts(const float* k, int max_steps, int n_phase) {
  MarchConsts c;
  for (int i = 0; i < 3; ++i) {
    c.bbox[i] = k[i];
    c.inv_bbox[i] = pow2_recip(k[i]);
    c.lo[i] = k[3 + i];
    c.hi[i] = k[6 + i];
    c.light[i] = k[11 + i];
    c.radiance[i] = k[14 + i];
  }
  c.step = k[9];
  c.dm = k[10];
  c.sun_ratio = k[17];
  c.max_steps = max_steps;
  c.n_phase = n_phase;
  return c;
}

}  // namespace ds

#ifndef DS_HOST_EMULATION

constexpr int kMarchThreads = 128;

// Rays x G threads: group g of G lanes marches ray blockIdx * (threads / G)
// + g.  counters[0] gains the lane-step slots of the block's warps (32 a
// warp's loop iteration, which lasts as long as its longest group),
// counters[1] the steps taken.
template <int G, typename T, int Skip = ds::kSkipNone>
__global__ void __launch_bounds__(kMarchThreads) march_lanes_kernel(
    const T* __restrict__ dens, const T* __restrict__ insc, int nx, int ny, int nz,
    const float* __restrict__ eval_rows, const float* __restrict__ entry,
    const float* __restrict__ dirs, const int64_t* __restrict__ ray_ids,
    const float* __restrict__ trans_total, uint32_t seed, int64_t n, ds::MarchConsts c,
    float* __restrict__ t_out, float* __restrict__ pos_out,
    uint8_t* __restrict__ ok_out, float* __restrict__ direct_out,
    unsigned long long* __restrict__ counters, ds::SkipArgs sk) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G: a power of two up to 32");
  __shared__ unsigned long long block_work[2];
  if (threadIdx.x < 2) block_work[threadIdx.x] = 0ull;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);  // lane within the group
  const int shift = lane - gl;  // the group's first lane in the warp
  const unsigned gmask = ds::lanes_below(G) << shift;
  const int64_t r = ((int64_t)blockIdx.x * kMarchThreads + threadIdx.x) / G;
  const bool valid = r < n;
  ds::Ray R;
  if (valid) {
    ds::ray_begin(R, r, entry, dirs, ray_ids, trans_total, seed, c);
  } else {
    R.active = false;
  }
  int chunks = 0;
  while (R.active) {  // uniform over the group
    ++chunks;
    ds::LaneSkip F = {false, false};
    ds::LaneStep S;
    if constexpr (Skip == ds::kSkipNone) {
      S = ds::lane_step<G>(R, gl, dens, nx, ny, nz, c);
    } else {
      S = ds::lane_step_skip<G, Skip>(R, gl, dens, nx, ny, nz, c, sk, F);
    }
    S.tn = ds::lane_transmittance<G>(R.trans, gl, [&](int k) {
      return __shfl_sync(gmask, S.e, k, G);
    });
    const unsigned leaves = __ballot_sync(gmask, ds::lane_leaves(S, c)) >> shift;
    const unsigned crosses = __ballot_sync(gmask, ds::lane_crosses(R, S)) >> shift;
    ds::ChunkEnd E;
    bool jump = false;
    if constexpr (Skip == ds::kSkipNone) {
      E = ds::chunk_end(leaves, crosses, c.max_steps - R.steps, G);
    } else {
      const unsigned cuts = __ballot_sync(gmask, F.cut) >> shift;
      const unsigned empties = __ballot_sync(gmask, F.empty) >> shift;
      E = ds::chunk_end_skip(leaves, crosses, cuts, empties, c.max_steps - R.steps, G, false,
                             jump);
    }
    ds::chunk_update(R, E, [&](int k) {
      ds::LaneStep X;
      X.ax = __shfl_sync(gmask, S.ax, k, G);
      X.ay = __shfl_sync(gmask, S.ay, k, G);
      X.az = __shfl_sync(gmask, S.az, k, G);
      X.density = __shfl_sync(gmask, S.density, k, G);
      X.e = 0.0f;
      X.tn = __shfl_sync(gmask, S.tn, k, G);
      return X;
    });
    if (jump) ds::chunk_jump(R, nx, ny, nz, c);
  }
  if (valid && gl == 0) {
    ds::ray_end(R, r, insc, nx, ny, nz, eval_rows, c, t_out, pos_out, ok_out, direct_out);
  }
  // The warp runs as long as its longest group.
  const int warp_chunks = __reduce_max_sync(0xffffffffu, chunks);
  const int steps = valid && gl == 0 ? R.steps : 0;
  const int warp_steps = __reduce_add_sync(0xffffffffu, steps);
  if (lane == 0) {
    atomicAdd(&block_work[0], (unsigned long long)warp_chunks * 32);
    atomicAdd(&block_work[1], (unsigned long long)warp_steps);
  }
  __syncthreads();
  if (threadIdx.x < 2) atomicAdd(&counters[threadIdx.x], block_work[threadIdx.x]);
}

// march_lanes_kernel<G> over n rays (ds_march's arguments).
template <int G, int Skip = ds::kSkipNone>
static int march_lanes(const void* dens, const void* insc, int is_u8, int nx, int ny,
                       int nz, const float* eval_rows, int n_phase, const float* entry,
                       const float* dirs, const int64_t* ray_ids,
                       const float* trans_total, uint32_t seed, int64_t n,
                       const float* consts, int max_steps, float* t_out, float* pos_out,
                       uint8_t* ok_out, float* direct_out,
                       unsigned long long* counters, void* stream,
                       const ds::SkipArgs& sk = ds::SkipArgs()) {
  cudaStream_t s = (cudaStream_t)stream;
  int err = (int)cudaMemsetAsync(counters, 0, 2 * sizeof(unsigned long long), s);
  if (err != 0 || n <= 0) return err;
  const ds::MarchConsts c = ds::march_consts(consts, max_steps, n_phase);
  const int64_t threads = n * G;
  const unsigned blocks = (unsigned)((threads + kMarchThreads - 1) / kMarchThreads);
  if (is_u8) {
    march_lanes_kernel<G, uint8_t, Skip><<<blocks, kMarchThreads, 0, s>>>(
        (const uint8_t*)dens, (const uint8_t*)insc, nx, ny, nz, eval_rows, entry, dirs,
        ray_ids, trans_total, seed, n, c, t_out, pos_out, ok_out, direct_out, counters, sk);
  } else {
    march_lanes_kernel<G, float, Skip><<<blocks, kMarchThreads, 0, s>>>(
        (const float*)dens, (const float*)insc, nx, ny, nz, eval_rows, entry, dirs,
        ray_ids, trans_total, seed, n, c, t_out, pos_out, ok_out, direct_out, counters, sk);
  }
  return (int)cudaGetLastError();
}

// consts: bbox[3], aabb_lo[3], aabb_hi[3], step, dm, light_dir[3],
// light_radiance[3], sun_solid_angle_ratio (18 host floats).  trans_total
// null selects pass 1; then pos_out, ok_out and direct_out may be null.
// counters: 2 uint64 (zeroed here): lane-step slots and steps.  Returns
// the first CUDA error of the memset and the launch, or 0.
extern "C" int ds_march(const void* dens, const void* insc, int is_u8, int nx, int ny,
                        int nz, const float* eval_rows, int n_phase, const float* entry,
                        const float* dirs, const int64_t* ray_ids,
                        const float* trans_total, uint32_t seed, int64_t n,
                        const float* consts, int max_steps, float* t_out,
                        float* pos_out, uint8_t* ok_out, float* direct_out,
                        unsigned long long* counters, void* stream) {
  return march_lanes<ds::kMarchLanes>(dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase,
                                      entry, dirs, ray_ids, trans_total, seed, n, consts,
                                      max_steps, t_out, pos_out, ok_out, direct_out,
                                      counters, stream);
}

// ds_march with the occupancy-block skip (skip kSkipBlock, the neural
// camera's only skip: the JAX package's pipelined march drops the cell
// jump); both passes take the same long steps.  Returns
// cudaErrorInvalidValue for another skip.
extern "C" int ds_march_skip(const void* dens, const void* insc, int is_u8, int nx, int ny,
                             int nz, const float* eval_rows, int n_phase, const float* entry,
                             const float* dirs, const int64_t* ray_ids,
                             const float* trans_total, uint32_t seed, int64_t n,
                             const float* consts, int max_steps, float* t_out,
                             float* pos_out, uint8_t* ok_out, float* direct_out,
                             unsigned long long* counters, void* stream, DS_SKIP_PARAMS) {
  if (skip != ds::kSkipBlock || occ == nullptr) return (int)cudaErrorInvalidValue;
  return march_lanes<ds::kMarchLanes, ds::kSkipBlock>(
      dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase, entry, dirs, ray_ids, trans_total,
      seed, n, consts, max_steps, t_out, pos_out, ok_out, direct_out, counters, stream,
      DS_SKIP_ARGS);
}

// The lanes a ray of ds_march (G).
extern "C" int ds_march_lanes() { return ds::kMarchLanes; }

#endif  // DS_HOST_EMULATION
