// K5: light-probe interpolation, the baked renderer's probe inputs.
//
// Replaces the XLA gather program of deepestscatter_tpu/render/baked.py::
// interpolate_probes (lines 125-144) over ops/tetra.py::probe_interpolation
// (lines 82-106), followed by the omega and alpha angles of shade_baked
// (lines 170-175): the output is the [N, 202] probe_in rows
// ProbeRendererModel consumes (200 interpolated latents, omega, alpha).
//
// Per shading point (probe_point): the lattice-unit position pos * dm / 6,
// the cell max(floor, 0) and the local position (before that clamp); the
// four half-space tests (local - v) . n_v < 1/sqrt(3) in the reference's
// priority order, the first passing test choosing its corner tetrahedron,
// else the central one; the barycentric weights as four scalar triple
// products times one reciprocal of the cell volume's; the four corners
// clamped to the lattice; omega = acos(clip(light . view)) and alpha, the
// signed angle about the light axis between eY of the view's light frame
// and eY of the probe direction's (0, 0, 1).  Per channel (probe_channel):
// the four corners' latents (uint8 / 256, or float32) weighted and summed
// left to right.  Every expression repeats render/baked.py::
// interpolate_probes_plain in its order; with -fmad=false the two are equal
// bitwise.
//
// Design (redesigned for Hopper; the first design stays as
// probes_first_kernel, entry point ds_probes_first, for comparison):
//   1. Every lane computes one point: a warp takes 32 consecutive points,
//      lane l computes point l's selection, weights and angles
//      (probe_point, two light frames and two acosf) into the warp's 32
//      ProbePoints in shared memory (40 B each; a block of kProbeThreads =
//      64 threads holds 2.5 KB).  The first design computed 16 points with
//      16 of 256 threads while the other 240 waited at __syncthreads.
//   2. Then the warp writes its 32 rows as (point, word) tasks: a row is
//      50 words of 4 latent channels and one word of (omega, alpha).  Task
//      t = 32 i + lane walks the 32 x 51 tasks in row order with an
//      incremental (point, word) pair (no division).  A latent word reads
//      4 bytes (uint8 lattices, a 200 B row is 50 aligned words) or a
//      float4 (float32 lattices, 800 B rows) of each corner probe;
//      probe_word computes the 4 channels with probe_channel's
//      expressions.  Consecutive lanes take consecutive words, so a warp's
//      loads of a corner row are contiguous (and the 4 corners of a warp's
//      neighbouring points mostly the same rows, from L1).
//   3. Each lane stores its 4 floats as two float2 (a 202-float row is
//      808 B, so every row starts 8-byte aligned).
//   4. Warps never wait for each other (__syncwarp only), so one warp's
//      point phase overlaps another's stores.  At the BNN frame's 53,657
//      points that is 1,677 warps in 839 blocks of two, all resident at
//      once over the 132 SMs.
// The task loop is uniform over the warp (a lane without a task idles
// through the last step): with a loop whose trip count differs by lane
// the kernel took 0.0369 ms at the BNN frame, no faster than the first
// design (H100 at 700 W, chip_smoke.py).  Alternatives measured and
// removed: loading 3 or 6 tasks a lane before their stores (BNN frame
// 0.0299 and 0.0416 ms against 0.0299 at 1), so the loads' latency does
// not bound it; staging a warp's 32 tasks in shared memory and storing
// them as contiguous float2 (0.027-0.031 ms against 0.022 with the stores
// here, on a 35^3 random lattice at 53,657 points).
// The first design (a block of 256 threads, 16 points; the elements at
// stride 256 with a division by 202 each, a byte per corner and a float
// store per element) took 0.0373 and 0.0368 ms on an H100 at 700 W, 2.7x
// the bound.
//
// Bound on the card: bytes.  At the BNN frame (53,655 points, 35^3 uint8
// probes) the distinct probes the points touch are read once (at most the
// 8.6 MB lattice, which the 50 MB L2 holds, so the four corners' 800 B a
// point come from L2) and the 43.4 MB of rows are written once; the
// arithmetic (chip_smoke.py's count: 330 operations a point, 15 a channel)
// takes a fifth of that time.
#include "common.cuh"

namespace ds {

constexpr int kProbeLength = 200;
constexpr int kProbeInWidth = kProbeLength + 2;  // latents, omega, alpha

// Corner k of tetrahedron t (ops/tetra.py::TETRA_CORNERS) as x + 2 y + 4 z,
// three bits at bit 3 (4 t + k): t = 0: 0 1 2 4; t = 1: 6 4 2 7; t = 2:
// 5 4 1 7; t = 3: 3 2 1 7; t = 4: 1 2 4 7.
constexpr uint64_t kTetraCorners = 0xf11e53e65ea6888ull;

// Coordinate `axis` (0 x, 1 y, 2 z) of corner k of tetrahedron t.
__device__ __forceinline__ int tetra_corner(int t, int k, int axis) {
  return (int)((kTetraCorners >> (3 * (4 * t + k) + axis)) & 1ull);
}

struct ProbeConsts {
  float units;          // float32(density_multiplier / 6)
  float inv_sqrt3;      // float32(1 / sqrt(3))
  float normal[4][3];   // the half-space tests' unit normals
  int n[3];             // probes per axis (x, y, z)
};

// A point's corner probes (flat lattice indices), weights and angles.
struct ProbePoint {
  int idx[4];
  float w[4];
  float omega;
  float alpha;
};

__device__ __forceinline__ float sum3(float a, float b, float c) { return (a + b) + c; }

// (a x b) . c, the cross product component by component.
__device__ __forceinline__ float sctp(const float* a, const float* b, const float* c) {
  const float x = a[1] * b[2] - a[2] * b[1];
  const float y = a[2] * b[0] - a[0] * b[2];
  const float z = a[0] * b[1] - a[1] * b[0];
  return sum3(x * c[0], y * c[1], z * c[2]);
}

__device__ __forceinline__ ProbePoint probe_point(int p, const float* __restrict__ pos,
                                                  const float* __restrict__ dirs,
                                                  const float* __restrict__ ez,
                                                  const float* __restrict__ light,
                                                  const ProbeConsts& c) {
  ProbePoint P;
  float local[3];
  int cell[3];
  for (int a = 0; a < 3; ++a) {
    const float u = pos[3 * p + a] * c.units;
    const float f = floorf(u);
    local[a] = u - f;
    cell[a] = (int)fmaxf(f, 0.0f);
  }
  // The first passing test wins.  The test vertices (0,0,0), (0,1,1),
  // (1,0,1), (1,1,0) are the first corners of tetrahedra 0..3.
  int t = 4;
  for (int k = 0; k < 4; ++k) {
    const float proj = sum3((local[0] - (float)tetra_corner(k, 0, 0)) * c.normal[k][0],
                            (local[1] - (float)tetra_corner(k, 0, 1)) * c.normal[k][1],
                            (local[2] - (float)tetra_corner(k, 0, 2)) * c.normal[k][2]);
    if (proj < c.inv_sqrt3) {
      t = k;
      break;
    }
  }
  float corner[4][3];
  for (int k = 0; k < 4; ++k) {
    for (int a = 0; a < 3; ++a) corner[k][a] = (float)tetra_corner(t, k, a);
  }
  float vap[3], vbp[3], vab[3], vac[3], vad[3], vbc[3], vbd[3];
  for (int a = 0; a < 3; ++a) {
    vap[a] = local[a] - corner[0][a];
    vbp[a] = local[a] - corner[1][a];
    vab[a] = corner[1][a] - corner[0][a];
    vac[a] = corner[2][a] - corner[0][a];
    vad[a] = corner[3][a] - corner[0][a];
    vbc[a] = corner[2][a] - corner[1][a];
    vbd[a] = corner[3][a] - corner[1][a];
  }
  const float inv = 1.0f / sctp(vab, vac, vad);
  P.w[0] = sctp(vbp, vbd, vbc) * inv;
  P.w[1] = sctp(vap, vac, vad) * inv;
  P.w[2] = sctp(vap, vad, vab) * inv;
  P.w[3] = sctp(vap, vab, vac) * inv;
  for (int k = 0; k < 4; ++k) {
    int ci[3];
    for (int a = 0; a < 3; ++a) {
      const int v = cell[a] + tetra_corner(t, k, a);
      ci[a] = v < 0 ? 0 : (v > c.n[a] - 1 ? c.n[a] - 1 : v);
    }
    P.idx[k] = (ci[2] * c.n[1] + ci[1]) * c.n[0] + ci[0];
  }
  const float vx = dirs[3 * p], vy = dirs[3 * p + 1], vz = dirs[3 * p + 2];
  P.omega = omega_angle(light, vx, vy, vz);
  const PointFrame V = point_frame(ez, vx, vy, vz);
  const PointFrame R = point_frame(ez, 0.0f, 0.0f, 1.0f);
  const float cos_a = fminf(fmaxf(sum3(V.yx * R.yx, V.yy * R.yy, V.yz * R.yz), -1.0f), 1.0f);
  const float ey_v[3] = {V.yx, V.yy, V.yz};
  const float ey_p[3] = {R.yx, R.yy, R.yz};
  const float ez_v[3] = {V.zx, V.zy, V.zz};
  P.alpha = acosf(cos_a) * (sctp(ey_v, ey_p, ez_v) < 0.0f ? -1.0f : 1.0f);
  return P;
}

__device__ __forceinline__ float probe_value(const uint8_t* __restrict__ g, int i) {
  return (float)g[i] * 0.00390625f;  // / 256, exact
}

__device__ __forceinline__ float probe_value(const float* __restrict__ g, int i) { return g[i]; }

// Element `ch` of a point's probe_in row.
template <typename T>
__device__ __forceinline__ float probe_channel(const ProbePoint& P, int ch,
                                               const T* __restrict__ probes) {
  if (ch == kProbeLength) return P.omega;
  if (ch == kProbeLength + 1) return P.alpha;
  float acc = probe_value(probes, P.idx[0] * kProbeLength + ch) * P.w[0];
  acc = acc + probe_value(probes, P.idx[1] * kProbeLength + ch) * P.w[1];
  acc = acc + probe_value(probes, P.idx[2] * kProbeLength + ch) * P.w[2];
  return acc + probe_value(probes, P.idx[3] * kProbeLength + ch) * P.w[3];
}

// Four consecutive latent values of a lattice from element i (a multiple
// of 4): one aligned 4-byte load of uint8 values (dequantized as
// probe_value does), one float4 of float32 values.
struct Word4 {
  float v[4];
};

__device__ __forceinline__ Word4 probe_word_values(const uint8_t* __restrict__ g, int i) {
#ifdef DS_HOST_EMULATION
  uint32_t x = 0;
  for (int j = 0; j < 4; ++j) x |= (uint32_t)g[i + j] << (8 * j);
#else
  const uint32_t x = __ldg(reinterpret_cast<const unsigned int*>(g + i));
#endif
  Word4 W;
  for (int j = 0; j < 4; ++j) W.v[j] = (float)((x >> (8 * j)) & 0xffu) * 0.00390625f;
  return W;
}

__device__ __forceinline__ Word4 probe_word_values(const float* __restrict__ g, int i) {
  Word4 W;
#ifdef DS_HOST_EMULATION
  for (int j = 0; j < 4; ++j) W.v[j] = g[i + j];
#else
  const float4 f = __ldg(reinterpret_cast<const float4*>(g + i));
  W.v[0] = f.x;
  W.v[1] = f.y;
  W.v[2] = f.z;
  W.v[3] = f.w;
#endif
  return W;
}

// Channels 4 w .. 4 w + 3 (w < 50) of a point's latents: probe_channel's
// expressions on a word of each corner's row.
template <typename T>
__device__ __forceinline__ void probe_word(const ProbePoint& P, int w,
                                           const T* __restrict__ probes, float* out) {
  const Word4 a = probe_word_values(probes, P.idx[0] * kProbeLength + 4 * w);
  const Word4 b = probe_word_values(probes, P.idx[1] * kProbeLength + 4 * w);
  const Word4 c = probe_word_values(probes, P.idx[2] * kProbeLength + 4 * w);
  const Word4 d = probe_word_values(probes, P.idx[3] * kProbeLength + 4 * w);
  for (int j = 0; j < 4; ++j) {
    float acc = a.v[j] * P.w[0];
    acc = acc + b.v[j] * P.w[1];
    acc = acc + c.v[j] * P.w[2];
    out[j] = acc + d.v[j] * P.w[3];
  }
}

// Host constants: f = units, inv_sqrt3, normals[4][3]; n = probes per axis.
inline ProbeConsts probe_consts(const float* f, int nx, int ny, int nz) {
  ProbeConsts c;
  c.units = f[0];
  c.inv_sqrt3 = f[1];
  for (int k = 0; k < 4; ++k) {
    for (int a = 0; a < 3; ++a) c.normal[k][a] = f[2 + 3 * k + a];
  }
  c.n[0] = nx;
  c.n[1] = ny;
  c.n[2] = nz;
  return c;
}

}  // namespace ds

#ifndef DS_HOST_EMULATION

// Words of a probe_in row: 50 of four latent channels, then (omega, alpha).
constexpr int kProbeWords = ds::kProbeLength / 4 + 1;
constexpr int kProbeThreads = 64;

// A warp's 32 points, then its 32 x 51 (point, word) tasks, 32 at a time.
template <typename T>
__global__ void __launch_bounds__(kProbeThreads) probes_kernel(
    const T* __restrict__ probes, const float* __restrict__ pos,
    const float* __restrict__ dirs, const float* __restrict__ ez,
    const float* __restrict__ light, int n, ds::ProbeConsts c, float* __restrict__ out) {
  __shared__ ds::ProbePoint pts[kProbeThreads];
  const int lane = threadIdx.x & 31;
  const int warp_base = (int)threadIdx.x - lane;
  const int first = blockIdx.x * kProbeThreads + warp_base;  // the warp's first point
  if (first >= n) return;  // the whole warp
  if (first + lane < n) {
    pts[threadIdx.x] = ds::probe_point(first + lane, pos, dirs, ez, light, c);
  }
  __syncwarp();
  const ds::ProbePoint* wp = pts + warp_base;
  const int count = n - first < 32 ? n - first : 32;
  float* o = out + (int64_t)first * ds::kProbeInWidth;
  const int tasks = count * kProbeWords;
  int q = 0, w = lane;  // task lane: point 0, word lane (lane < kProbeWords)
  for (int t0 = 0; t0 < tasks; t0 += 32) {  // uniform over the warp
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int nf = 0;
    const int off = q * ds::kProbeInWidth + 4 * w;  // floats into the warp's rows
    if (t0 + lane < tasks) {
      const ds::ProbePoint& P = wp[q];
      if (w < kProbeWords - 1) {
        ds::probe_word(P, w, probes, v);
        nf = 4;
      } else {
        v[0] = P.omega;
        v[1] = P.alpha;
        nf = 2;
      }
      float2* dst = reinterpret_cast<float2*>(o + off);
      dst[0] = make_float2(v[0], v[1]);
      if (nf == 4) dst[1] = make_float2(v[2], v[3]);
    }
    w += 32;
    if (w >= kProbeWords) {
      w -= kProbeWords;
      ++q;
    }
  }
}

// The first design: a block of kFirstThreads threads takes kFirstPoints
// points, the first kFirstPoints threads computing them into shared
// memory, then every thread takes elements at stride kFirstThreads.
constexpr int kFirstThreads = 256;
constexpr int kFirstPoints = 16;

template <typename T>
__global__ void __launch_bounds__(kFirstThreads) probes_first_kernel(
    const T* __restrict__ probes, const float* __restrict__ pos,
    const float* __restrict__ dirs, const float* __restrict__ ez,
    const float* __restrict__ light, int n, ds::ProbeConsts c, float* __restrict__ out) {
  __shared__ ds::ProbePoint pts[kFirstPoints];
  const int first = blockIdx.x * kFirstPoints;
  const int count = n - first < kFirstPoints ? n - first : kFirstPoints;
  if ((int)threadIdx.x < count) {
    pts[threadIdx.x] = ds::probe_point(first + threadIdx.x, pos, dirs, ez, light, c);
  }
  __syncthreads();
  float* o = out + (int64_t)first * ds::kProbeInWidth;
  const int total = count * ds::kProbeInWidth;
  for (int e = threadIdx.x; e < total; e += kFirstThreads) {
    const int q = e / ds::kProbeInWidth;
    o[e] = ds::probe_channel(pts[q], e - q * ds::kProbeInWidth, probes);
  }
}

template <template <typename> class Launch>
static int probes_launch(const void* probes, int is_u8, int nx, int ny, int nz,
                         const float* pos, const float* dirs, const float* ez,
                         const float* light, int64_t n, const float* consts, float* out,
                         void* stream) {
  if (n <= 0) return 0;
  if (n >= ((int64_t)1 << 31) / ds::kProbeInWidth) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)probes & 15u) != 0 || ((uintptr_t)out & 7u) != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  const ds::ProbeConsts c = ds::probe_consts(consts, nx, ny, nz);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_u8) {
    Launch<uint8_t>::run((const uint8_t*)probes, pos, dirs, ez, light, (int)n, c, out, s);
  } else {
    Launch<float>::run((const float*)probes, pos, dirs, ez, light, (int)n, c, out, s);
  }
  return (int)cudaGetLastError();
}

template <typename T>
struct WarpLaunch {
  static void run(const T* probes, const float* pos, const float* dirs, const float* ez,
                  const float* light, int n, const ds::ProbeConsts& c, float* out,
                  cudaStream_t s) {
    const unsigned blocks = (unsigned)((n + kProbeThreads - 1) / kProbeThreads);
    probes_kernel<T><<<blocks, kProbeThreads, 0, s>>>(probes, pos, dirs, ez, light, n, c, out);
  }
};

template <typename T>
struct FirstLaunch {
  static void run(const T* probes, const float* pos, const float* dirs, const float* ez,
                  const float* light, int n, const ds::ProbeConsts& c, float* out,
                  cudaStream_t s) {
    const unsigned blocks = (unsigned)((n + kFirstPoints - 1) / kFirstPoints);
    probes_first_kernel<T><<<blocks, kFirstThreads, 0, s>>>(probes, pos, dirs, ez, light, n,
                                                             c, out);
  }
};

// Fills out[n, 202] from the probes [nz, ny, nx, 200] (uint8 or float32)
// at the points pos[n, 3] seen along dirs[n, 3]; ez = -light / |light|.
// consts: units, inv_sqrt3, normals[4][3].  The lattice must hold fewer
// than 2^31 latents and start 16-byte aligned, out 8-byte aligned.
extern "C" int ds_probes(const void* probes, int is_u8, int nx, int ny, int nz,
                         const float* pos, const float* dirs, const float* ez,
                         const float* light, int64_t n, const float* consts, float* out,
                         void* stream) {
  return probes_launch<WarpLaunch>(probes, is_u8, nx, ny, nz, pos, dirs, ez, light, n, consts,
                                   out, stream);
}

// ds_probes through the first design.
extern "C" int ds_probes_first(const void* probes, int is_u8, int nx, int ny, int nz,
                               const float* pos, const float* dirs, const float* ez,
                               const float* light, int64_t n, const float* consts, float* out,
                               void* stream) {
  return probes_launch<FirstLaunch>(probes, is_u8, nx, ny, nz, pos, dirs, ez, light, n, consts,
                                    out, stream);
}

#endif  // DS_HOST_EMULATION
