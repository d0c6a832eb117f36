// K8c's first design (csrc/path_adjoint.cu): a thread a (sample, pixel)
// item doing both passes, the replay at lookahead 1 into the item's
// flights, then the sweep, each flight re-marched by one thread with the
// runs of steps in one cell summed in registers.  It is the per-item
// statement of what the package's two kernels compute; csrc/
// path_adjoint_variants.cu builds it as a kernel to time it against them,
// and tests/torch_kernel_host.cpp runs it on the CPU.  Include after
// path_adjoint.cu.
#pragma once

namespace ds {
namespace path {

// Pass 1: the sample S (begun by begin_item) to its end with K4's
// functions at lookahead 1, each flight recorded into seg[0 ..).  Returns
// the flights.
__device__ __forceinline__ int replay(Sample& S, const PathArgs& a, Segment* __restrict__ seg) {
  const PtConsts& c = a.c;
  int n = 0;
  while (n < a.max_segments) {
    Segment& g = seg[n];
    g.x[0] = S.px;
    g.x[1] = S.py;
    g.x[2] = S.pz;
    g.w[0] = S.dx;
    g.w[1] = S.dy;
    g.w[2] = S.dz;
    g.weight = S.weight;
    g.sigma = g.trans = g.back = 0.0f;
    const int depth = S.depth, steps0 = S.steps;
    Crossing X;
    int state;
    do {
      state = march_steps<1>(S, X, a.dens, a.nx, a.ny, a.nz, c);
    } while (state == kMarching);
    g.steps = S.steps - steps0;
    ++n;
    if (state == kEnded) {
      // A cap or the depth test leaves the sample in the box; a free step
      // out of the box leaves it outside.
      g.info = depth << 2 | (in_box(S.px, S.py, S.pz, c.bbox) ? kEndCut : kEndExit);
      return n;
    }
    g.sigma = X.density;
    g.trans = X.tn;
    g.back = back_distance(S.od, X.tn, X.density);
    const bool inb = in_box(X.ax - S.dx * g.back, X.ay - S.dy * g.back, X.az - S.dz * g.back,
                            c.bbox);
    g.info = depth << 2 | (inb ? kEndScatter : kEndEscape);
    if (resolve(S, X, a.insc, a.nx, a.ny, a.nz, a.eval_rows, a.inv, c)) return n;
  }
  return n;
}

// Flight g's re-march for its sigma adjoints (c0 at steps 1 .. K-1, cK at
// step K), along the forward's chain of positions from its start: the
// density texels (runs of steps in one cell summed in registers, added
// when the cell changes and at the end), the slopes summed in float64 into
// sx and, times j step, into sw.
template <class Add>
__device__ __forceinline__ void remarch_steps(const float* __restrict__ dens,
                                              const diff::Grid3& gr, const PtConsts& c,
                                              const Segment& g, float c0, float cK,
                                              double* d_dens, double* sx, double* sw,
                                              const Add& add) {
  float p[3] = {g.x[0], g.x[1], g.x[2]};
  int key = -1, run_idx[8];
  float run_v[8];
  for (int j = 1; j <= g.steps; ++j) {
    p[0] = p[0] + g.w[0] * c.step;
    p[1] = p[1] + g.w[1] * c.step;
    p[2] = p[2] + g.w[2] * c.step;
    float u[3];
    diff::unit_coords(gr, p, u);
    const diff::Taps tp = diff::taps_at(gr, u[0], u[1], u[2]);
    const float sb = (j == g.steps ? cK : c0) * c.dm;  // d trilinear
    if (tp.idx[0] != key) {
      if (key >= 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k) add(d_dens + run_idx[k], run_v[k]);
      }
      key = tp.idx[0];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        run_idx[k] = tp.idx[k];
        run_v[k] = sb * tp.w[k];
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) run_v[k] += sb * tp.w[k];
    }
    float dp[3];
    diff::taps_point_slope(dens, gr, tp, sb, dp);
    const float dist = (float)j * c.step;
    for (int t = 0; t < 3; ++t) {
      sx[t] += (double)dp[t];
      sw[t] += (double)(dp[t] * dist);
    }
  }
  if (key >= 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) add(d_dens + run_idx[k], run_v[k]);
  }
}

// Pass 2: the flights seg[0 .. n) of sample `it` swept from the last, a
// flight's a_K and scatter point recomputed with the forward's
// expressions.  Adds the grids' and the light's gradients; writes d/d entry
// into de and d/d the pixel's direction into dd.  Returns the steps it
// re-marched.
template <class Add>
__device__ __forceinline__ int sweep(const PathArgs& a, const Segment* __restrict__ seg, int n,
                                     const SweepItem& it, float* de, float* dd, LightGrads& L,
                                     const Add& add) {
  float xb[3] = {0.0f, 0.0f, 0.0f}, wb[3] = {0.0f, 0.0f, 0.0f};
  int remarched = 0;
  for (int d = n - 1; d >= 0; --d) {
    const Segment& g = seg[d];
    float s[3] = {0.0f, 0.0f, 0.0f};
    if ((g.info & 3) == kEndScatter) {
      float ax = g.x[0], ay = g.x[1], az = g.x[2];
      for (int j = 0; j < g.steps; ++j) {
        ax = ax + g.w[0] * a.c.step;
        ay = ay + g.w[1] * a.c.step;
        az = az + g.w[2] * a.c.step;
      }
      s[0] = ax - g.w[0] * g.back;
      s[1] = ay - g.w[1] * g.back;
      s[2] = az - g.w[2] * g.back;
    }
    float c0, cK;
    if (flight_head(a, g, s, it, xb, wb, c0, cK, L, 0, 1, add)) {
      double sx[3] = {0.0, 0.0, 0.0}, sw[3] = {0.0, 0.0, 0.0};
      remarch_steps(a.dens, a.gr, a.c, g, c0, cK, a.d_dens, sx, sw, add);
      for (int t = 0; t < 3; ++t) {
        xb[t] += (float)sx[t];
        wb[t] += (float)sw[t];
      }
      remarched += g.steps;
    }
  }
  sweep_tail(a, it, xb, wb, de, dd);
  return remarched;
}

// Item i: both passes; the record, d entry and d dirs at K4's item, the
// re-marched steps where asked; L gets the item's light gradients.  Items
// of pixels without a box hit write zeros.
template <class Add>
__device__ __forceinline__ void adjoint_item(const PathArgs& a, int64_t i, LightGrads& L,
                                             const Add& add) {
  const SweepItem it = sweep_item(a, i);
  float de[3] = {0.0f, 0.0f, 0.0f}, dd[3] = {0.0f, 0.0f, 0.0f};
  int remarched = 0;
  if (a.hit[it.r]) {
    Sample S;
    if (begin_item(S, it.item, a.n, a.entry, a.dirs, a.hit, a.ray_ids, a.inv, a.c, a.seed_base,
                   a.sub_first, nullptr, a.rec_rad, a.rec_work)) {
      Segment* seg = a.seg + i * (int64_t)a.max_segments;
      const int flights = replay(S, a, seg);
      write_record(S, it.item, a.rec_rad, a.rec_work);
      if (it.gout[0] != 0.0f || it.gout[1] != 0.0f || it.gout[2] != 0.0f) {
        remarched = sweep(a, seg, flights, it, de, dd, L, add);
      }
    }
  } else {
    for (int j = 0; j < 3; ++j) a.rec_rad[3 * it.item + j] = 0.0f;
    a.rec_work[2 * it.item] = a.rec_work[2 * it.item + 1] = 0;
  }
  for (int j = 0; j < 3; ++j) {
    a.d_entry[3 * it.item + j] = de[j];
    a.d_dirs[3 * it.item + j] = dd[j];
  }
  if (a.remarch != nullptr) a.remarch[it.item] = remarched;
}

}  // namespace path
}  // namespace ds
