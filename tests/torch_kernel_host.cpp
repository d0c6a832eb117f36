// Host build of the path-trace (K4) and in-scatter bake (K3) kernels'
// device functions, for tests/test_torch_kernel_host.py:
//
//   g++ -O2 -std=c++17 -shared -fPIC -ffp-contract=off -DDS_HOST_EMULATION
//       -D__device__= -D__forceinline__=inline
//       -I deepestscatter_tpu_torch/csrc tests/torch_kernel_host.cpp
//
// It exports ds_pathtrace and ds_bake with the signatures of the device
// entry points, so the wrappers' _launch drives it on CPU tensors;
// host_set_pathtrace and host_set_bake choose what they compute.
#include <math.h>
#include <stdint.h>

#include <vector>

#include "pathtrace.cu"
#include "inscatter.cu"

namespace {

int pt_mode = 1;  // 0: pathtrace_pixel over the pixels; 1: items, then the fold
int pt_lookahead = ds::kLookahead;
const int64_t* pt_order = nullptr;  // the items' order (nullptr: 0, 1, 2, ...)
int bake_mode = 1;  // 0: bake_voxel over the voxels; 1: bake_row over the rows

template <int K, typename T>
void trace_items(const T* dens, const T* insc, int nx, int ny, int nz,
                 const float* eval_rows, const float* inv, const float* entry,
                 const float* dirs, const uint8_t* hit, const int64_t* ray_ids, int64_t n,
                 int64_t n_items, const ds::PtConsts& c, uint32_t seed_base,
                 uint32_t sub_first, float* rec_rad, int32_t* rec_work) {
  for (int64_t i = 0; i < n_items; ++i) {
    const int64_t item = pt_order ? pt_order[i] : i;
    ds::Sample S;
    if (!ds::begin_item(S, item, n, entry, dirs, hit, ray_ids, inv, c, seed_base, sub_first,
                        rec_rad, rec_work)) {
      continue;
    }
    while (!ds::march_chunk<K>(S, dens, insc, nx, ny, nz, eval_rows, inv, c)) {
    }
    ds::write_record(S, item, rec_rad, rec_work);
  }
}

template <typename T>
int pathtrace(const T* dens, const T* insc, int nx, int ny, int nz, const float* eval_rows,
              const float* inv, const float* entry, const float* dirs, const uint8_t* hit,
              const int64_t* ray_ids, int64_t n, const ds::PtConsts& c, uint32_t seed_base,
              uint32_t sub_first, int n_samples, float* rec_rad, int32_t* rec_work,
              float* mean_out, float* m2_out, float* count_out, int64_t* work_out) {
  if (pt_mode == 0) {
    for (int64_t r = 0; r < n; ++r) {
      ds::pathtrace_pixel(r, dens, insc, nx, ny, nz, eval_rows, inv, entry, dirs, hit,
                          ray_ids, c, seed_base, sub_first, n_samples, mean_out, m2_out,
                          count_out, work_out);
    }
    return 0;
  }
  const int64_t n_items = n * (int64_t)n_samples;
#define DS_ITEMS(K)                                                                      \
  trace_items<K>(dens, insc, nx, ny, nz, eval_rows, inv, entry, dirs, hit, ray_ids, n, \
                 n_items, c, seed_base, sub_first, rec_rad, rec_work)
  if (pt_lookahead == 1) {
    DS_ITEMS(1);
  } else if (pt_lookahead == ds::kLookahead) {
    DS_ITEMS(ds::kLookahead);
  } else {
    return -1;
  }
#undef DS_ITEMS
  for (int64_t r = 0; r < n; ++r) {
    ds::fold_pixel(r, n, n_samples, hit, rec_rad, rec_work, mean_out, m2_out, count_out,
                   work_out);
  }
  return 0;
}

template <typename T>
void bake(const T* dens, int nx, int ny, int nz, const ds::BakeConsts& c, int n_steps,
          int early_out, float* out) {
  if (bake_mode == 0) {
    const int64_t n = (int64_t)nx * ny * nz;
    for (int64_t v = 0; v < n; ++v) out[v] = ds::bake_voxel(v, dens, nx, ny, nz, c, n_steps, early_out);
    return;
  }
  std::vector<float> rows(4 * (size_t)nx);
  for (int z = 0; z < nz; ++z) {
    for (int y = 0; y < ny; ++y) {
      ds::bake_row(y, z, dens, nx, ny, nz, c, n_steps, early_out, rows.data(),
                   out + ((int64_t)z * ny + y) * nx);
    }
  }
}

}  // namespace

extern "C" {

// mode 0: the per-pixel loop; mode 1: the work items in `order` (NULL: in
// item order) marched `lookahead` steps a chunk (1, or 0 for the kernel's
// kLookahead), then folded.
void host_set_pathtrace(int mode, int lookahead, const int64_t* order) {
  pt_mode = mode;
  pt_lookahead = lookahead > 0 ? lookahead : ds::kLookahead;
  pt_order = order;
}

// mode 0: bake_voxel a voxel; mode 1: bake_row a row.
void host_set_bake(int mode) { bake_mode = mode; }

int ds_pathtrace(const void* dens, const void* insc, int is_u8, int nx, int ny, int nz,
                 const float* eval_rows, int n_phase, const float* inv_rows, int n_inv,
                 const float* entry, const float* dirs, const uint8_t* hit,
                 const int64_t* ray_ids, int64_t n, const float* consts, const float* ground,
                 int max_steps, int max_depth, int rr_start, int flags, uint32_t seed_base,
                 uint32_t sub_first, int n_samples, float* rec_rad, int32_t* rec_work,
                 unsigned long long* counters, float* mean_out, float* m2_out,
                 float* count_out, int64_t* work_out, void* /*stream*/) {
  if (n <= 0) return 0;
  const ds::PtConsts c =
      ds::pt_consts(consts, ground, max_steps, max_depth, rr_start, n_phase, n_inv, flags);
  counters[0] = (unsigned long long)(n * n_samples);
  counters[1] = 0;
  if (is_u8) {
    return pathtrace((const uint8_t*)dens, (const uint8_t*)insc, nx, ny, nz, eval_rows,
                     inv_rows, entry, dirs, hit, ray_ids, n, c, seed_base, sub_first,
                     n_samples, rec_rad, rec_work, mean_out, m2_out, count_out, work_out);
  }
  return pathtrace((const float*)dens, (const float*)insc, nx, ny, nz, eval_rows, inv_rows,
                   entry, dirs, hit, ray_ids, n, c, seed_base, sub_first, n_samples, rec_rad,
                   rec_work, mean_out, m2_out, count_out, work_out);
}

int ds_bake(const void* dens, int is_u8, int nx, int ny, int nz, const float* consts,
            int n_steps, int early_out, float* out, void* /*stream*/) {
  const ds::BakeConsts c = ds::bake_consts(consts);
  if (is_u8) {
    bake((const uint8_t*)dens, nx, ny, nz, c, n_steps, early_out, out);
  } else {
    bake((const float*)dens, nx, ny, nz, c, n_steps, early_out, out);
  }
  return 0;
}

}  // extern "C"
