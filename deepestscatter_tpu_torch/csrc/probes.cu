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
// Design: a block of kProbeThreads threads takes kBlockPoints consecutive
// points.  The first kBlockPoints threads compute their point's selection,
// weights and angles once into shared memory; then every thread takes
// (point, channel) elements of the block's rows at stride kProbeThreads,
// so consecutive threads read consecutive latent bytes of a corner probe
// and write consecutive output floats.
//
// Bound on the card: bytes.  At the BNN frame (53,655 points, 35^3 uint8
// probes) the distinct probes the points touch are read once (at most the
// 8.6 MB lattice, which the 50 MB L2 holds, so the four corners' 800 B a
// point come from L2) and the 43.4 MB of rows are written once; the
// arithmetic is about 2,600 operations a point.
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

constexpr int kProbeThreads = 256;
constexpr int kBlockPoints = 16;

template <typename T>
__global__ void __launch_bounds__(kProbeThreads) probes_kernel(
    const T* __restrict__ probes, const float* __restrict__ pos,
    const float* __restrict__ dirs, const float* __restrict__ ez,
    const float* __restrict__ light, int n, ds::ProbeConsts c, float* __restrict__ out) {
  __shared__ ds::ProbePoint pts[kBlockPoints];
  const int first = blockIdx.x * kBlockPoints;
  const int count = n - first < kBlockPoints ? n - first : kBlockPoints;
  if ((int)threadIdx.x < count) {
    pts[threadIdx.x] = ds::probe_point(first + threadIdx.x, pos, dirs, ez, light, c);
  }
  __syncthreads();
  float* o = out + (int64_t)first * ds::kProbeInWidth;
  const int total = count * ds::kProbeInWidth;
  for (int e = threadIdx.x; e < total; e += kProbeThreads) {
    const int q = e / ds::kProbeInWidth;
    o[e] = ds::probe_channel(pts[q], e - q * ds::kProbeInWidth, probes);
  }
}

// Fills out[n, 202] from the probes [nz, ny, nx, 200] (uint8 or float32)
// at the points pos[n, 3] seen along dirs[n, 3]; ez = -light / |light|.
// consts: units, inv_sqrt3, normals[4][3].  The lattice must hold fewer
// than 2^31 latents.
extern "C" int ds_probes(const void* probes, int is_u8, int nx, int ny, int nz,
                         const float* pos, const float* dirs, const float* ez,
                         const float* light, int64_t n, const float* consts, float* out,
                         void* stream) {
  if (n <= 0) return 0;
  if (n >= ((int64_t)1 << 31) / ds::kProbeInWidth) return (int)cudaErrorInvalidValue;
  const ds::ProbeConsts c = ds::probe_consts(consts, nx, ny, nz);
  const unsigned blocks = (unsigned)((n + kBlockPoints - 1) / kBlockPoints);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_u8) {
    probes_kernel<uint8_t><<<blocks, kProbeThreads, 0, s>>>(
        (const uint8_t*)probes, pos, dirs, ez, light, (int)n, c, out);
  } else {
    probes_kernel<float><<<blocks, kProbeThreads, 0, s>>>(
        (const float*)probes, pos, dirs, ez, light, (int)n, c, out);
  }
  return (int)cudaGetLastError();
}

#endif  // DS_HOST_EMULATION
