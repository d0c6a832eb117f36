// Alternatives of the cell jump of K4 and K7b (csrc/pathtrace.cu with
// kSkipCell) and of K4's block skip (kSkipBlock), for
// probes/march_variants.py --jump-only and --skip-only and chip_smoke.py's
// skip phase.  The cell jump (ds_jump_variant):
//   design 0, the first design: march_steps_skip, where a jump ends its
//     lookahead chunk and its exit takes cell_exit_steps' ten divisions;
//   design 1, the package's kernels (march_steps_jump with FaceExit: the
//     jump inside the chunk, the exit from the launch's face table);
//   design 2, the probe: the first design's march without the jump, each
//     exit it would take computed and added to the pixel's jumped count,
//     the sample left where it is and the chunk not ended (the records are
//     those of the kernels without a skip), so that the exit's arithmetic
//     is timed apart from the chunk it ends;
//   design 3: the jump inside the chunk with the first design's divided
//     exit (march_steps_jump with DividedExit).
//   design 4: design 0 counting the jumps it takes (ds_jump_count);
//   design 5: the package's kSkipCell instantiation (the faces from the
//     face table in shared memory) on every grid, where the package takes
//     kSkipCellPow2 (the faces by product) on a grid whose cell counts are
//     powers of two.
//   design 6: the package's jump with the exit choosing each axis's faces
//     at run time (by product where the axis's cell count is a power of
//     two, else from the table: MixedExit), in one kernel for every grid.
// Designs 0, 1, 3, 4, 5 and 6 compute the same values.  Designs 0, 2, 3 and 4
// run in copies of the package's two queues (pathtrace_items_kernel,
// radiance_items_kernel) with the march a template argument.
// K4's block skip (ds_block_variant): design 0, the first design
// (march_steps_skip, the float32 occupancy read at every step, in the copy
// of K4's queue); design 1, the package's kernel (march_steps_block: the
// density certificate, the occupancy's bits).  Both compute the same
// values.
//
// A source of its own: it includes only csrc/pathtrace.cu, so chip_smoke.py
// builds it beside the package's sources.  The package's entry points are
// renamed where they are included; ds_pathtrace_skip and ds_radiance_skip
// here take the same arguments and run the design ds_jump_variant chose, so
// the wrappers' lib= argument drives them.
#define ds_pathtrace ds_pathtrace_package
#define ds_radiance ds_radiance_package
#define ds_pathtrace_skip ds_pathtrace_skip_package
#define ds_radiance_skip ds_radiance_skip_package
#define ds_radiance_park_at ds_radiance_park_at_package
#define ds_pathtrace_registers ds_pathtrace_registers_package
#include "pathtrace.cu"
#undef ds_pathtrace
#undef ds_radiance
#undef ds_pathtrace_skip
#undef ds_radiance_skip
#undef ds_radiance_park_at
#undef ds_pathtrace_registers

namespace {

enum : int {
  kFirst = 0,
  kPackage = 1,
  kProbe = 2,
  kDivided = 3,
  kFirstCounted = 4,
  kTable = 5,
  kMixed = 6,
  kBlockFirst = 7  // the block skip's first design in the queue's copy
};

// The first design's march (design 4 is design 0 counting its jumps).
template <int D>
constexpr bool kFirstMarch = D == kFirst || D == kFirstCounted;

int g_design = kPackage;
// ds_block_variant's design: 0 the first, 1 the package's.
int g_block = 1;
// The jumps the last launch of design 4 took (a device word, allocated at
// its first launch): a jump ends its chunk there, so a chunk after which
// S.jumped grew took one.  Designs 0, 1 and 3 take the same jumps.
unsigned long long* g_jumps = nullptr;

// The probe (design 2): march_steps_skip's cell jump with the exit taken
// and discarded (added to S.jumped); the cap on the steps alone, as
// march_steps has it.
template <int K, typename T>
__device__ __forceinline__ int march_steps_probe(ds::Sample& S, ds::Crossing& X,
                                                 const T* __restrict__ dens, int nx, int ny,
                                                 int nz, const ds::PtConsts& c) {
  float dens_k[K], e_k[K];
  bool zero_k[K];
  float qx = S.px, qy = S.py, qz = S.pz;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    qx = qx + S.dx * c.step;
    qy = qy + S.dy * c.step;
    qz = qz + S.dz * c.step;
    float cmax;
    dens_k[k] = ds::trilinear_strided_max(dens, nx, ny, nz,
                                          ds::div_exact(qx, c.bbox[0], c.inv_bbox[0]),
                                          ds::div_exact(qy, c.bbox[1], c.inv_bbox[1]),
                                          ds::div_exact(qz, c.bbox[2], c.inv_bbox[2]), cmax) *
                c.dm;
    zero_k[k] = cmax <= 0.0f;
    e_k[k] = expf(-dens_k[k] * c.step);
  }
  int state = ds::kMarching;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (state == ds::kMarching) {
      if (S.steps >= c.max_steps) {
        state = ds::kEnded;
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
          state = ds::kCrossed;
        } else if (ds::free_step(S, c, ax, ay, az, tn)) {
          state = ds::kEnded;
        } else if (zero_k[k]) {
          S.jumped += (int)ds::cell_exit_steps(
              nx, ny, nz, c.bbox, c.step, ds::div_exact(ax, c.bbox[0], c.inv_bbox[0]),
              ds::div_exact(ay, c.bbox[1], c.inv_bbox[1]),
              ds::div_exact(az, c.bbox[2], c.inv_bbox[2]), ax, ay, az, S.dx, S.dy, S.dz,
              c.max_steps - S.steps);
        }
      }
    }
  }
  return state;
}

// Design 6's exit: FaceExit's, each axis's faces by product or from the
// table as its reciprocal is or is not 0.
struct MixedExit {
  ds::FaceExit<true> product;
  ds::FaceExit<false> table;

  __device__ __forceinline__ float axis(int a, int c, float p, float d) const {
    const int i = d > 0.0f ? c + 1 : c;
    const float bound = product.inv[a] != 0.0f ? product.face(a, i) : table.face(a, i);
    return fabsf(d) > 1e-9f ? (bound - p) / d : INFINITY;
  }

  __device__ __forceinline__ float operator()(int cx, int cy, int cz, float /*ux*/,
                                              float /*uy*/, float /*uz*/, float px, float py,
                                              float pz, float dx, float dy, float dz,
                                              int room) const {
    const float t = fminf(fminf(axis(0, cx, px, dx), axis(1, cy, py, dy)), axis(2, cz, pz, dz));
    const float e = fminf(floorf(ds::div_exact(fmaxf(t, 0.0f), product.step, product.inv_step)),
                          ds::kMaxJump);
    return fminf(e, (float)room);
  }
};

// Design 6's exit of a launch: the face table in shared memory where an
// axis's cell count is no power of two.
__device__ __forceinline__ MixedExit shared_mixed_exit(int nx, int ny, int nz,
                                                       const ds::PtConsts& c,
                                                       const ds::SkipArgs& sk) {
  extern __shared__ float faces[];
  if (sk.inv_cells[0] == 0.0f || sk.inv_cells[1] == 0.0f || sk.inv_cells[2] == 0.0f) {
    const int size = ds::face_table_size(nx, ny, nz);
    for (int i = threadIdx.x; i < size; i += blockDim.x) {
      faces[i] = ds::face_table_entry(i, nx, ny, nz, c.bbox);
    }
    __syncthreads();
  }
  return MixedExit{ds::face_exit_of<true>(faces, nx, ny, c.bbox, c.step, sk),
                   ds::face_exit_of<false>(faces, nx, ny, c.bbox, c.step, sk)};
}

// Design D's march of K steps (designs 0, 2, 3, 4 and 6; `jump` design 6's
// exit).
template <int D, int K, typename T>
__device__ __forceinline__ int variant_steps(ds::Sample& S, ds::Crossing& X,
                                             const T* __restrict__ dens, int nx, int ny, int nz,
                                             const ds::PtConsts& c, const ds::SkipArgs& sk,
                                             const MixedExit& jump) {
  if constexpr (kFirstMarch<D>) {
    return ds::march_steps_skip<K, ds::kSkipCell>(S, X, dens, nx, ny, nz, c, sk);
  } else if constexpr (D == kProbe) {
    return march_steps_probe<K>(S, X, dens, nx, ny, nz, c);
  } else if constexpr (D == kMixed) {
    return ds::march_steps_jump<K>(S, X, dens, nx, ny, nz, c, jump);
  } else {
    return ds::march_steps_jump<K>(S, X, dens, nx, ny, nz, c,
                                   ds::DividedExit{nx, ny, nz, c.bbox, c.step});
  }
}

// Design D's march and scatter: march_chunk_skip for the first designs, as
// their kernels ran it.
template <int D, int K, typename T>
__device__ __forceinline__ bool variant_chunk(ds::Sample& S, const T* __restrict__ dens,
                                              const T* __restrict__ insc, int nx, int ny, int nz,
                                              const float* __restrict__ eval_rows,
                                              const float* __restrict__ inv,
                                              const ds::PtConsts& c, const ds::SkipArgs& sk,
                                              const MixedExit& jump) {
  if constexpr (kFirstMarch<D>) {
    return ds::march_chunk_skip<K, ds::kSkipCell>(S, dens, insc, nx, ny, nz, eval_rows, inv, c,
                                                  sk);
  } else if constexpr (D == kBlockFirst) {
    return ds::march_chunk_skip<K, ds::kSkipBlock>(S, dens, insc, nx, ny, nz, eval_rows, inv, c,
                                                   sk);
  } else {
    ds::Crossing X;
    const int state = variant_steps<D, K>(S, X, dens, nx, ny, nz, c, sk, jump);
    if (state == ds::kCrossed) return ds::resolve(S, X, insc, nx, ny, nz, eval_rows, inv, c);
    return state == ds::kEnded;
  }
}

}  // namespace

// pathtrace_items_kernel (K4's queue) with design D's march.
template <int D, int K, typename T>
__global__ void __launch_bounds__(kPtThreads) jump_items_kernel(
    const T* __restrict__ dens, const T* __restrict__ insc, int nx, int ny, int nz,
    const float* __restrict__ eval_rows, const float* __restrict__ inv,
    const float* __restrict__ entry, const float* __restrict__ dirs,
    const uint8_t* __restrict__ hit, const int64_t* __restrict__ ray_ids, int64_t n,
    int64_t n_items, ds::PtConsts c, uint32_t seed_base, uint32_t sub_first,
    const uint32_t* __restrict__ sub0, float* __restrict__ rec_rad,
    int32_t* __restrict__ rec_work, unsigned long long* __restrict__ counters,
    ds::SkipArgs sk, unsigned long long* __restrict__ jumps) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  MixedExit jump{};
  if constexpr (D == kMixed) jump = shared_mixed_exit(nx, ny, nz, c, sk);
  ds::Sample S;
  int64_t item = 0;
  bool have = false, drained = false;
  unsigned long long iters = 0, taken = 0;
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
          have = ds::begin_item(S, item, n, entry, dirs, hit, ray_ids, inv, c, seed_base,
                                sub_first, sub0, rec_rad, rec_work);
          S.jumped = 0;
        }
      }
    }
    if (!__any_sync(kFullMask, have)) break;
    ++iters;
    const int before = S.jumped;
    if (have && variant_chunk<D, K>(S, dens, insc, nx, ny, nz, eval_rows, inv, c, sk, jump)) {
      ds::write_record(S, item, rec_rad, rec_work);
      ds::add_jumped<ds::kSkipCell>(sk, item, n, S);
      have = false;
    }
    if (D == kFirstCounted && S.jumped != before) ++taken;
  }
  if (lane == 0) atomicAdd(&counters[1], iters * K);
  if (D == kFirstCounted && taken != 0) atomicAdd(jumps, taken);
}

// radiance_items_kernel (K7b's warp of deferred scatters) with design D's
// march.
template <int D, int K, typename T>
__global__ void __launch_bounds__(kPtThreads, ds::kRadianceBlocks) jump_radiance_kernel(
    const T* __restrict__ dens, const T* __restrict__ insc, int nx, int ny, int nz,
    const float* __restrict__ eval_rows, const float* __restrict__ inv,
    const float* __restrict__ entry, const float* __restrict__ dirs,
    const uint8_t* __restrict__ hit, const int64_t* __restrict__ ray_ids, int64_t n,
    int n_samples, ds::PtConsts c, uint32_t seed_base, const uint32_t* __restrict__ sub0,
    int park_at, float* __restrict__ rec_rad, int32_t* __restrict__ rec_work,
    unsigned long long* __restrict__ counters, ds::SkipArgs sk,
    unsigned long long* __restrict__ jumps) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int64_t n_items = n * (int64_t)n_samples;
  MixedExit jump{};
  if constexpr (D == kMixed) jump = shared_mixed_exit(nx, ny, nz, c, sk);
  ds::Sample S;
  ds::Crossing X;
  int64_t item = 0;
  bool have = false, parked = false, drained = false;
  unsigned long long iters = 0, resolves = 0, resolved = 0, taken = 0;
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
          S.jumped = 0;
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
          ds::add_jumped<ds::kSkipCell>(sk, item, n, S);
          have = false;
        }
      }
    } else {
      ++iters;
      if (have && !parked) {
        const int before = S.jumped;
        const int state = variant_steps<D, K>(S, X, dens, nx, ny, nz, c, sk, jump);
        if (D == kFirstCounted && S.jumped != before) ++taken;
        if (state == ds::kEnded) {
          ds::write_record(S, item, rec_rad, rec_work);
          ds::add_jumped<ds::kSkipCell>(sk, item, n, S);
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
  if (D == kFirstCounted && taken != 0) atomicAdd(jumps, taken);
}

namespace {

// Design D of K4 (radiance false: sub0 null, sub_first) or K7b (sub0, at
// kParkAt) on texel type T at the package's lookahead, then the fold
// (pathtrace_queue's and radiance_queue's launches).
template <int D, typename T>
int variant_launch(bool radiance, const T* dens, const T* insc, int nx, int ny, int nz,
                   const float* eval_rows, const float* inv_rows, const float* entry,
                   const float* dirs, const uint8_t* hit, const int64_t* ray_ids, int64_t n,
                   const ds::PtConsts& c, uint32_t seed_base, uint32_t sub_first,
                   const uint32_t* sub0, int n_samples, float* rec_rad, int32_t* rec_work,
                   unsigned long long* counters, float* mean_out, float* m2_out,
                   float* count_out, int64_t* work_out, cudaStream_t s, const ds::SkipArgs& sk) {
  constexpr int K = ds::kLookahead;
  const int64_t n_items = n * (int64_t)n_samples;
  int err = 0;
  if (g_jumps == nullptr) err = (int)cudaMalloc(&g_jumps, sizeof(unsigned long long));
  if (err == 0) err = (int)cudaMemsetAsync(g_jumps, 0, sizeof(unsigned long long), s);
  if (err == 0) err = (int)cudaMemsetAsync(counters, 0, 4 * sizeof(unsigned long long), s);
  if (err == 0) err = (int)cudaMemsetAsync(sk.jumped, 0, n * sizeof(unsigned long long), s);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == 0) err = (int)cudaGetDevice(&dev);
  if (err == 0) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem =
      D == kMixed && !ds::pow2_cells(nx, ny, nz) ? skip_shared_bytes<ds::kSkipCell>(nx, ny, nz) : 0;
  // The block skip runs in K4's queue alone (K7b takes only the cell jump).
  constexpr bool kItemsOnly = D == kBlockFirst;
  if (kItemsOnly && radiance && err == 0) err = (int)cudaErrorInvalidValue;
  if (err == 0) {
    if constexpr (kItemsOnly) {
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, jump_items_kernel<D, K, T>, kPtThreads, smem);
    } else {
      err = radiance ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &per_sm, jump_radiance_kernel<D, K, T>, kPtThreads, smem)
                     : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &per_sm, jump_items_kernel<D, K, T>, kPtThreads, smem);
    }
  }
  if (err != 0) return err;
  const int64_t needed = (n_items + kPtThreads - 1) / kPtThreads;
  const int64_t full = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  const unsigned blocks = (unsigned)(needed < full ? needed : full);
  if constexpr (!kItemsOnly) {
    if (radiance) {
      jump_radiance_kernel<D, K, T><<<blocks, kPtThreads, smem, s>>>(
          dens, insc, nx, ny, nz, eval_rows, inv_rows, entry, dirs, hit, ray_ids, n, n_samples,
          c, seed_base, sub0, ds::kParkAt, rec_rad, rec_work, counters, sk, g_jumps);
    }
  }
  if (!radiance) {
    jump_items_kernel<D, K, T><<<blocks, kPtThreads, smem, s>>>(
        dens, insc, nx, ny, nz, eval_rows, inv_rows, entry, dirs, hit, ray_ids, n, n_items, c,
        seed_base, sub_first, sub0, rec_rad, rec_work, counters, sk, g_jumps);
  }
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  fold_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      hit, n, n_samples, rec_rad, rec_work, mean_out, m2_out, count_out, work_out);
  return (int)cudaGetLastError();
}

template <int D>
int variant_texels(bool radiance, const void* dens, const void* insc, int is_u8, int nx, int ny,
                   int nz, const float* eval_rows, int n_phase, const float* inv_rows, int n_inv,
                   const float* entry, const float* dirs, const uint8_t* hit,
                   const int64_t* ray_ids, int64_t n, const float* consts, const float* ground,
                   int max_steps, int max_depth, int rr_start, int flags, uint32_t seed_base,
                   uint32_t sub_first, const uint32_t* sub0, int n_samples, float* rec_rad,
                   int32_t* rec_work, unsigned long long* counters, float* mean_out,
                   float* m2_out, float* count_out, int64_t* work_out, void* stream,
                   const ds::SkipArgs& sk) {
  const ds::PtConsts c =
      ds::pt_consts(consts, ground, max_steps, max_depth, rr_start, n_phase, n_inv, flags);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_u8) {
    return variant_launch<D>(radiance, (const uint8_t*)dens, (const uint8_t*)insc, nx, ny, nz,
                             eval_rows, inv_rows, entry, dirs, hit, ray_ids, n, c, seed_base,
                             sub_first, sub0, n_samples, rec_rad, rec_work, counters, mean_out,
                             m2_out, count_out, work_out, s, sk);
  }
  return variant_launch<D>(radiance, (const float*)dens, (const float*)insc, nx, ny, nz,
                           eval_rows, inv_rows, entry, dirs, hit, ray_ids, n, c, seed_base,
                           sub_first, sub0, n_samples, rec_rad, rec_work, counters, mean_out,
                           m2_out, count_out, work_out, s, sk);
}

// Registers, local (spill) bytes and resident blocks a SM of a kernel.
template <typename F>
int attributes(F kernel, size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, kPtThreads, smem);
  return (int)e;
}

template <typename T>
int jump_attributes(int design, int radiance, int* out) {
  constexpr int K = ds::kLookahead;
  switch (design * 2 + (radiance ? 1 : 0)) {
    case 0: return attributes(jump_items_kernel<kFirst, K, T>, 0, out);
    case 1: return attributes(jump_radiance_kernel<kFirst, K, T>, 0, out);
    case 2: return attributes(pathtrace_items_kernel<K, T, ds::kSkipCellPow2>, 0, out);
    case 3: return attributes(radiance_items_kernel<K, T, ds::kSkipCellPow2>, 0, out);
    case 4: return attributes(jump_items_kernel<kProbe, K, T>, 0, out);
    case 5: return attributes(jump_radiance_kernel<kProbe, K, T>, 0, out);
    case 6: return attributes(jump_items_kernel<kDivided, K, T>, 0, out);
    case 7: return attributes(jump_radiance_kernel<kDivided, K, T>, 0, out);
    case 10: return attributes(pathtrace_items_kernel<K, T, ds::kSkipCell>, 0, out);
    case 11: return attributes(radiance_items_kernel<K, T, ds::kSkipCell>, 0, out);
    case 12: return attributes(jump_items_kernel<kMixed, K, T>, 0, out);
    case 13: return attributes(jump_radiance_kernel<kMixed, K, T>, 0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int block_attributes(int design, int* out) {
  constexpr int K = ds::kLookahead;
  switch (design) {
    case 0: return attributes(jump_items_kernel<kBlockFirst, K, T>, 0, out);
    case 1: return attributes(pathtrace_items_kernel<K, T, ds::kSkipBlock>, 0, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The design ds_pathtrace_skip and ds_radiance_skip run: 0 the first, 1 the
// package's, 2 the probe, 3 the jump inside the chunk with divided exits,
// 4 the first counting its jumps (ds_jump_count), 5 the package's with
// the faces from the face table on every grid, 6 each axis's faces chosen
// at run time.
void ds_jump_variant(int design) { g_design = design; }

// The march's lookahead (the steps a march slot counts).
int ds_jump_lookahead() { return ds::kLookahead; }

// The jumps the last launch of design 4 took (0 before one), after the
// card finished it.
unsigned long long ds_jump_count() {
  unsigned long long v = 0;
  if (g_jumps != nullptr) cudaMemcpy(&v, g_jumps, sizeof(v), cudaMemcpyDeviceToHost);
  return v;
}

// The registers, local bytes (spills) and resident blocks a SM (without
// the face table's shared memory) of design `design`'s K4 (radiance 0) or
// K7b (1) kernel on uint8 (is_u8 1) or float32 textures into out[3]; the
// package's (design 1) kSkipCellPow2, design 5 its kSkipCell.
int ds_jump_attributes(int design, int radiance, int is_u8, int* out) {
  return is_u8 ? jump_attributes<uint8_t>(design, radiance, out)
               : jump_attributes<float>(design, radiance, out);
}

// The block skip's design ds_pathtrace_skip runs (0 the first, 1 the
// package's).
void ds_block_variant(int design) { g_block = design; }

// ds_jump_attributes of the block skip's design `design`.
int ds_block_attributes(int design, int is_u8, int* out) {
  return is_u8 ? block_attributes<uint8_t>(design, out) : block_attributes<float>(design, out);
}

int ds_pathtrace(const void* dens, const void* insc, int is_u8, int nx, int ny, int nz,
                 const float* eval_rows, int n_phase, const float* inv_rows, int n_inv,
                 const float* entry, const float* dirs, const uint8_t* hit,
                 const int64_t* ray_ids, int64_t n, const float* consts, const float* ground,
                 int max_steps, int max_depth, int rr_start, int flags, uint32_t seed_base,
                 uint32_t sub_first, int n_samples, float* rec_rad, int32_t* rec_work,
                 unsigned long long* counters, float* mean_out, float* m2_out,
                 float* count_out, int64_t* work_out, void* stream) {
  return ds_pathtrace_package(dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase, inv_rows,
                              n_inv, entry, dirs, hit, ray_ids, n, consts, ground, max_steps,
                              max_depth, rr_start, flags, seed_base, sub_first, n_samples,
                              rec_rad, rec_work, counters, mean_out, m2_out, count_out, work_out,
                              stream);
}

int ds_radiance(const void* dens, const void* insc, int is_u8, int nx, int ny, int nz,
                const float* eval_rows, int n_phase, const float* inv_rows, int n_inv,
                const float* entry, const float* dirs, const uint8_t* hit,
                const int64_t* ray_ids, int64_t n, const float* consts, const float* ground,
                int max_steps, int max_depth, int rr_start, int flags, uint32_t seed_base,
                const uint32_t* sub0, int n_samples, float* rec_rad, int32_t* rec_work,
                unsigned long long* counters, float* mean_out, float* m2_out,
                float* count_out, int64_t* work_out, void* stream) {
  return ds_radiance_package(dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase, inv_rows, n_inv,
                             entry, dirs, hit, ray_ids, n, consts, ground, max_steps, max_depth,
                             rr_start, flags, seed_base, sub0, n_samples, rec_rad, rec_work,
                             counters, mean_out, m2_out, count_out, work_out, stream);
}

#define DS_VARIANT(D, RADIANCE, SUB_FIRST, SUB0)                                              \
  variant_texels<D>(RADIANCE, dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase, inv_rows,    \
                    n_inv, entry, dirs, hit, ray_ids, n, consts, ground, max_steps, max_depth, \
                    rr_start, flags, seed_base, SUB_FIRST, SUB0, n_samples, rec_rad, rec_work, \
                    counters, mean_out, m2_out, count_out, work_out, stream,            \
                    ds::cell_recips(DS_SKIP_ARGS, nx, ny, nz, consts[3]))

int ds_pathtrace_skip(const void* dens, const void* insc, int is_u8, int nx, int ny, int nz,
                      const float* eval_rows, int n_phase, const float* inv_rows, int n_inv,
                      const float* entry, const float* dirs, const uint8_t* hit,
                      const int64_t* ray_ids, int64_t n, const float* consts,
                      const float* ground, int max_steps, int max_depth, int rr_start,
                      int flags, uint32_t seed_base, uint32_t sub_first, int n_samples,
                      float* rec_rad, int32_t* rec_work, unsigned long long* counters,
                      float* mean_out, float* m2_out, float* count_out, int64_t* work_out,
                      void* stream, DS_SKIP_PARAMS) {
  if (skip == ds::kSkipBlock && g_block == 0) {
    if (n <= 0) return 0;
    if (jumped == nullptr || occ == nullptr) return (int)cudaErrorInvalidValue;
    return DS_VARIANT(kBlockFirst, false, sub_first, nullptr);
  }
  if (g_design == kPackage || skip != ds::kSkipCell) {
    return ds_pathtrace_skip_package(dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase,
                                     inv_rows, n_inv, entry, dirs, hit, ray_ids, n, consts,
                                     ground, max_steps, max_depth, rr_start, flags, seed_base,
                                     sub_first, n_samples, rec_rad, rec_work, counters, mean_out,
                                     m2_out, count_out, work_out, stream, skip, occ, occ_x,
                                     occ_y, occ_z, block, long_steps, jumped, occ_bits,
                                     sure_steps);
  }
  if (n <= 0) return 0;
  if (jumped == nullptr) return (int)cudaErrorInvalidValue;
  switch (g_design) {
    case kFirst: return DS_VARIANT(kFirst, false, sub_first, nullptr);
    case kFirstCounted: return DS_VARIANT(kFirstCounted, false, sub_first, nullptr);
    case kMixed: return DS_VARIANT(kMixed, false, sub_first, nullptr);
    case kTable:
      if (skip_shared_bytes<ds::kSkipCell>(nx, ny, nz) > (size_t)ds::kMaxFaceTableBytes) {
        return (int)cudaErrorInvalidValue;
      }
      return pathtrace_queue<ds::kLookahead, ds::kSkipCell>(
          dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase, inv_rows, n_inv, entry, dirs, hit,
          ray_ids, n, consts, ground, max_steps, max_depth, rr_start, flags, seed_base,
          sub_first, n_samples, rec_rad, rec_work, counters, mean_out, m2_out, count_out,
          work_out, stream, nullptr, ds::cell_recips(DS_SKIP_ARGS, nx, ny, nz, consts[3]));
    case kProbe: return DS_VARIANT(kProbe, false, sub_first, nullptr);
    case kDivided: return DS_VARIANT(kDivided, false, sub_first, nullptr);
    default: return (int)cudaErrorInvalidValue;
  }
}

int ds_radiance_skip(const void* dens, const void* insc, int is_u8, int nx, int ny, int nz,
                     const float* eval_rows, int n_phase, const float* inv_rows, int n_inv,
                     const float* entry, const float* dirs, const uint8_t* hit,
                     const int64_t* ray_ids, int64_t n, const float* consts,
                     const float* ground, int max_steps, int max_depth, int rr_start,
                     int flags, uint32_t seed_base, const uint32_t* sub0, int n_samples,
                     float* rec_rad, int32_t* rec_work, unsigned long long* counters,
                     float* mean_out, float* m2_out, float* count_out, int64_t* work_out,
                     void* stream, DS_SKIP_PARAMS) {
  if (g_design == kPackage || skip != ds::kSkipCell) {
    return ds_radiance_skip_package(dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase, inv_rows,
                                    n_inv, entry, dirs, hit, ray_ids, n, consts, ground,
                                    max_steps, max_depth, rr_start, flags, seed_base, sub0,
                                    n_samples, rec_rad, rec_work, counters, mean_out, m2_out,
                                    count_out, work_out, stream, skip, occ, occ_x, occ_y, occ_z,
                                    block, long_steps, jumped, occ_bits, sure_steps);
  }
  if (n <= 0) return 0;
  if (sub0 == nullptr || jumped == nullptr) return (int)cudaErrorInvalidValue;
  switch (g_design) {
    case kFirst: return DS_VARIANT(kFirst, true, 0u, sub0);
    case kFirstCounted: return DS_VARIANT(kFirstCounted, true, 0u, sub0);
    case kMixed: return DS_VARIANT(kMixed, true, 0u, sub0);
    case kTable:
      if (skip_shared_bytes<ds::kSkipCell>(nx, ny, nz) > (size_t)ds::kMaxFaceTableBytes) {
        return (int)cudaErrorInvalidValue;
      }
      return radiance_queue<ds::kLookahead, ds::kSkipCell>(
          dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase, inv_rows, n_inv, entry, dirs, hit,
          ray_ids, n, consts, ground, max_steps, max_depth, rr_start, flags, seed_base, sub0,
          n_samples, ds::kParkAt, rec_rad, rec_work, counters, mean_out, m2_out, count_out,
          work_out, stream, ds::cell_recips(DS_SKIP_ARGS, nx, ny, nz, consts[3]));
    case kProbe: return DS_VARIANT(kProbe, true, 0u, sub0);
    case kDivided: return DS_VARIANT(kDivided, true, 0u, sub0);
    default: return (int)cudaErrorInvalidValue;
  }
}
#undef DS_VARIANT

}  // extern "C"
