// Host build of the path-trace (K4, and K7b: its per-pixel experiment
// bases and deferred scatters), in-scatter bake (K3), camera march (K1),
// descriptor (K2), probe interpolation (K5), scatter-sample (K7a, its
// rounds of attempts), batch-assembly (K10), adjoint-bake (K8a),
// quadrature-march (K8b), path-adjoint (K8c) and slab-march (K9) kernels'
// device functions, for
// tests/test_torch_kernel_host.py:
//
//   g++ -O2 -std=c++17 -shared -fPIC -ffp-contract=off -DDS_HOST_EMULATION
//       -D__device__= -D__forceinline__=inline
//       -I deepestscatter_tpu_torch/csrc tests/torch_kernel_host.cpp
//
// It exports ds_pathtrace, ds_radiance, ds_bake, ds_bake_planes,
// ds_spatial_phase, ds_march, ds_descriptor,
// ds_probes, ds_samples, ds_assemble_disney, ds_assemble_baked,
// ds_pathtrace_skip, ds_radiance_skip, ds_march_skip, ds_samples_skip,
// ds_bake_adjoint(_blocks), ds_diff_march, ds_diff_march_bwd, ds_sun_march,
// ds_sun_march_bwd and ds_path_adjoint(_blocks, ds_path_pixel_bytes) with
// the signatures of the device entry points (the atomics of K8a, K8b and
// K8c as plain adds; K8c's light gradients summed in partial row 0),
// so the wrappers' _launch drives it on CPU tensors; host_set_pathtrace,
// host_set_radiance, host_set_bake, host_set_march, host_set_descriptor,
// host_set_probes, host_set_samples, host_set_diff,
// host_set_diff_forward, host_set_path, host_set_spatial, host_set_jump and
// host_set_block choose what they compute
// (host_path_list returns K8c's last work list; host_face_table and
// host_exit_steps give the cell jump's face table and exits).
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <vector>

#include "pathtrace.cu"
#include "inscatter.cu"
#include "march.cu"
#include "descriptor.cu"
#include "probes.cu"
#include "samples.cu"
#include "assemble.cu"
#include "diff.cu"
#include "path_adjoint.cu"
#include "path_adjoint_first.cuh"
#include "spatial.cu"
#include "spatial_first.cuh"

namespace {

int pt_mode = 1;  // 0: pathtrace_pixel over the pixels; 1: items, then the fold
int pt_lookahead = ds::kLookahead;
const int64_t* pt_order = nullptr;  // the items' order (nullptr: 0, 1, 2, ...)
int bake_mode = 1;  // 0: bake_voxel over the voxels; 1: bake_row over the rows
int march_mode = 1;  // 0: march_ray a ray; 1: chunks of march_lanes lanes a ray
int march_lanes = ds::kMarchLanes;  // 1, 8 or 32
int desc_mode = 1;  // 0: descriptor_element an element; 1: descriptor_column a column
int probes_mode = 1;  // 0: probe_channel an element (first design); 1: probe_word a word
// 0: sample_attempts a sample; 1: its attempts in order, each in chunks of
// samples_lanes lanes (the first design); 2: rounds of samples_warps
// attempts, each in chunks of 32 lanes (the kernel's without a skip and
// with the block skip, and the cell jump's first design); 3: rounds of
// kAttemptGroup attempts, each on a thread at lookahead kAttemptLookahead
// (the cell jump's kernel, attempt_chunk_jump).
int samples_mode = 2;
int samples_lanes = 32;  // 1, 8 or 32
int samples_warps = ds::kSampleWarps;  // W of mode 2
// K7b (ds_radiance, where pt_mode is 1): 0 K4's items (its first design),
// 1 a warp of 32 lanes with deferred scatters resolved at radiance_park_at
// parked lanes (the kernel's).
int radiance_mode = 1;
int radiance_park_at = ds::kParkAt;
// K8a: 0 bake_adjoint_voxel a voxel (its first design); 1 bake_adjoint_row a
// row (the kernel's).  K8b's adjoint: 0 march_ray_adjoint a ray (its first
// design); 1 chunks of diff_lanes lanes a ray (the kernel's).
int adjoint_mode = 1;
int diff_mode = 1;
int diff_lanes = ds::diff::kDiffLanes;  // 1, 8 or 32
// K8b's forward: 0 march_ray a ray (its first design); 1 chunks of
// fwd_lanes lanes a ray (the kernel's).  The sun march and its adjoint: 0
// sun_march and sun_march_adjoint a point (their first designs); 1 chunks
// of sun_lanes lanes a point (csrc/diff_variants.cu's lane form); 2 a point
// at a time with strided samples and the adjoint's runs merged (the
// kernels').
int fwd_mode = 1;
int fwd_lanes = ds::diff::kDiffLanes;  // 1, 8 or 32
int sun_mode = 2;
int sun_lanes = 8;  // 1, 8 or 32
// K8c: 0 adjoint_item an item (its first design); 1 the replay over the
// items in path_order (NULL: in order), each sample to its end, appending
// the work list (path_list: its front the samples that re-march at least
// path_long_steps steps, the kernel's kLongSteps), then the sweep over the
// list with path_lanes lanes a sample.
int path_design = 1;
int path_lanes = ds::path::kSweepLanes;  // 1, 8 or 32
const int64_t* path_order = nullptr;
int path_long_steps = ds::path::kLongSteps;
std::vector<int64_t> path_list;  // the last launch's: its front, then its back
int64_t front_length = 0;
// K9: 0 phase_ray a ray (its first design); 1 ray_phase a ray with
// spatial_lanes lanes a ray (the kernel's groups, a chunk's lanes emulated
// one after the other; 1 a lane of one thread at K4's lookahead).
int spatial_design = 1;
int spatial_lanes = 1;  // 1, 4, 8, 16 or 32

// The skip of the running *_skip entry point (ds::kSkipNone in the others)
// and its arguments.
int skip_mode = ds::kSkipNone;
ds::SkipArgs skip_args = {};
// The cell jump's design: 0 the first (march_steps_skip: a jump ends its
// chunk); 1 the kernels' (march_steps_jump with FaceExit: the faces by
// product where every cell count is a power of two, kSkipCellPow2, else
// from the running launch's face table, face_table, kSkipCell); 2
// march_steps_jump with the first design's divided exit
// (csrc/pathtrace_variants.cu's); 3 kSkipCell's exit on every grid.
int jump_design = 1;
std::vector<float> face_table;
bool pow2_grid = false;  // the running launch's grid: every cell count a power of two
// K4's block skip, csrc/pathtrace_variants.cu's ds_block_variant: 0 the
// first design (march_steps_skip: the float32 occupancy read at every
// step); 1 the kernels' (march_steps_block: the bits, read where the
// density certificate does not cover a step).
int block_design = 1;
int block_sure = 0;  // the running sample's certified plain steps
int64_t block_reads = 0;  // the occupancy reads of the last block-skip launch

// BitBlocks counting its reads into block_reads.
struct CountedBlocks {
  ds::BitBlocks blocks;
  int steps(int nx, int ny, int nz, const float* bbox, const float* inv, float qx, float qy,
            float qz, int room) const {
    ++block_reads;
    return blocks.steps(nx, ny, nz, bbox, inv, qx, qy, qz, room);
  }
};

// The running launch's exit of the kernels' design: by product
// (kSkipCellPow2) or from the table (kSkipCell).
template <bool Product>
ds::FaceExit<Product> table_exit(int nx, int ny, const ds::PtConsts& c) {
  return ds::face_exit_of<Product>(face_table.data(), nx, ny, c.bbox, c.step, skip_args);
}

ds::DividedExit divided_exit(int nx, int ny, int nz, const ds::PtConsts& c) {
  return ds::DividedExit{nx, ny, nz, c.bbox, c.step};
}

void fill_face_table(int nx, int ny, int nz, const float* bbox) {
  pow2_grid = ds::pow2_cells(nx, ny, nz);
  face_table.resize(ds::face_table_size(nx, ny, nz));
  for (size_t i = 0; i < face_table.size(); ++i) {
    face_table[i] = ds::face_table_entry((int)i, nx, ny, nz, bbox);
  }
}

// march_chunk / march_steps with the running skip (march_chunk_skip,
// march_steps_any), a sample's jump count reset where it starts and added
// to its pixel where it ends.
template <int K, typename T>
bool chunk_skip(ds::Sample& S, const T* dens, const T* insc, int nx, int ny, int nz,
                const float* eval_rows, const float* inv, const ds::PtConsts& c) {
  switch (skip_mode) {
    case ds::kSkipCell:
      if (jump_design == 1 && pow2_grid) {
        return ds::march_chunk_jump<K>(S, dens, insc, nx, ny, nz, eval_rows, inv, c,
                                       table_exit<true>(nx, ny, c));
      }
      if (jump_design == 1 || jump_design == 3) {
        return ds::march_chunk_jump<K>(S, dens, insc, nx, ny, nz, eval_rows, inv, c,
                                       table_exit<false>(nx, ny, c));
      }
      if (jump_design == 2) {
        return ds::march_chunk_jump<K>(S, dens, insc, nx, ny, nz, eval_rows, inv, c,
                                       divided_exit(nx, ny, nz, c));
      }
      return ds::march_chunk_skip<K, ds::kSkipCell>(S, dens, insc, nx, ny, nz, eval_rows, inv, c,
                                                   skip_args);
    case ds::kSkipBlock:
      if (block_design == 1) {
        return ds::march_chunk_block<K>(S, dens, insc, nx, ny, nz, eval_rows, inv, c,
                                        CountedBlocks{ds::bit_blocks(skip_args)},
                                        skip_args.sure_steps, block_sure);
      }
      return ds::march_chunk_skip<K, ds::kSkipBlock>(S, dens, insc, nx, ny, nz, eval_rows, inv,
                                                    c, skip_args);
    default:
      return ds::march_chunk<K>(S, dens, insc, nx, ny, nz, eval_rows, inv, c);
  }
}

template <int K, typename T>
int steps_skip(ds::Sample& S, ds::Crossing& X, const T* dens, int nx, int ny, int nz,
               const ds::PtConsts& c) {
  switch (skip_mode) {
    case ds::kSkipCell:
      if (jump_design == 1 && pow2_grid) {
        return ds::march_steps_any<K, ds::kSkipCellPow2>(S, X, dens, nx, ny, nz, c, skip_args,
                                                         table_exit<true>(nx, ny, c));
      }
      if (jump_design == 1 || jump_design == 3) {
        return ds::march_steps_any<K, ds::kSkipCell>(S, X, dens, nx, ny, nz, c, skip_args,
                                                     table_exit<false>(nx, ny, c));
      }
      if (jump_design == 2) {
        return ds::march_steps_jump<K>(S, X, dens, nx, ny, nz, c, divided_exit(nx, ny, nz, c));
      }
      return ds::march_steps_skip<K, ds::kSkipCell>(S, X, dens, nx, ny, nz, c, skip_args);
    case ds::kSkipBlock:
      return ds::march_steps_skip<K, ds::kSkipBlock>(S, X, dens, nx, ny, nz, c, skip_args);
    default:
      return ds::march_steps<K>(S, X, dens, nx, ny, nz, c);
  }
}

void start_jumps(ds::Sample& S) {
  if (skip_mode != ds::kSkipNone) S.jumped = 0;
  block_sure = 0;
}

void end_jumps(const ds::Sample& S, int64_t item, int64_t n) {
  switch (skip_mode) {
    case ds::kSkipCell: ds::add_jumped<ds::kSkipCell>(skip_args, item, n, S); break;
    case ds::kSkipBlock: ds::add_jumped<ds::kSkipBlock>(skip_args, item, n, S); break;
    default: break;
  }
}

template <int K, typename T>
void trace_items(const T* dens, const T* insc, int nx, int ny, int nz,
                 const float* eval_rows, const float* inv, const float* entry,
                 const float* dirs, const uint8_t* hit, const int64_t* ray_ids, int64_t n,
                 int64_t n_items, const ds::PtConsts& c, uint32_t seed_base,
                 uint32_t sub_first, const uint32_t* sub0, float* rec_rad, int32_t* rec_work) {
  for (int64_t i = 0; i < n_items; ++i) {
    const int64_t item = pt_order ? pt_order[i] : i;
    ds::Sample S;
    if (!ds::begin_item(S, item, n, entry, dirs, hit, ray_ids, inv, c, seed_base, sub_first,
                        sub0, rec_rad, rec_work)) {
      continue;
    }
    start_jumps(S);
    while (!chunk_skip<K>(S, dens, insc, nx, ny, nz, eval_rows, inv, c)) {
    }
    ds::write_record(S, item, rec_rad, rec_work);
    end_jumps(S, item, n);
  }
}

// K7b's warp with deferred scatters: 32 lanes take the items in order (a
// lane whose item has no steps takes the next), and each warp step either
// resolves every parked crossing (resolve_now) or marches every unparked
// lane K steps (march_steps), the lanes one after the other.
template <int K, typename T>
void trace_items_deferred(const T* dens, const T* insc, int nx, int ny, int nz,
                          const float* eval_rows, const float* inv, const float* entry,
                          const float* dirs, const uint8_t* hit, const int64_t* ray_ids,
                          int64_t n, int64_t n_items, const ds::PtConsts& c,
                          uint32_t seed_base, const uint32_t* sub0, float* rec_rad,
                          int32_t* rec_work) {
  ds::Sample S[32];
  ds::Crossing X[32];
  int64_t item[32];
  bool have[32] = {}, parked[32] = {};
  int64_t next = 0;
  for (;;) {
    for (int l = 0; l < 32; ++l) {
      while (!have[l] && next < n_items) {
        item[l] = pt_order ? pt_order[next] : next;
        ++next;
        have[l] = ds::begin_item(S[l], item[l], n, entry, dirs, hit, ray_ids, inv, c,
                                 seed_base, 0u, sub0, rec_rad, rec_work);
        start_jumps(S[l]);
      }
    }
    int n_live = 0, n_parked = 0;
    for (int l = 0; l < 32; ++l) {
      n_live += have[l] ? 1 : 0;
      n_parked += parked[l] ? 1 : 0;
    }
    if (n_live == 0) return;
    const bool resolving = ds::resolve_now(n_parked, n_live, radiance_park_at);
    for (int l = 0; l < 32; ++l) {
      if (resolving && parked[l]) {
        parked[l] = false;
        if (ds::resolve(S[l], X[l], insc, nx, ny, nz, eval_rows, inv, c)) {
          ds::write_record(S[l], item[l], rec_rad, rec_work);
          end_jumps(S[l], item[l], n);
          have[l] = false;
        }
      } else if (!resolving && have[l] && !parked[l]) {
        const int state = steps_skip<K>(S[l], X[l], dens, nx, ny, nz, c);
        if (state == ds::kEnded) {
          ds::write_record(S[l], item[l], rec_rad, rec_work);
          end_jumps(S[l], item[l], n);
          have[l] = false;
        } else if (state == ds::kCrossed) {
          parked[l] = true;
        }
      }
    }
  }
}

template <typename T>
int pathtrace(const T* dens, const T* insc, int nx, int ny, int nz, const float* eval_rows,
              const float* inv, const float* entry, const float* dirs, const uint8_t* hit,
              const int64_t* ray_ids, int64_t n, const ds::PtConsts& c, uint32_t seed_base,
              uint32_t sub_first, const uint32_t* sub0, int n_samples, float* rec_rad,
              int32_t* rec_work, float* mean_out, float* m2_out, float* count_out,
              int64_t* work_out) {
  if (pt_mode == 0) {
    if (skip_mode != ds::kSkipNone) return -1;  // the per-pixel loop takes no skip
    for (int64_t r = 0; r < n; ++r) {
      ds::pathtrace_pixel(r, dens, insc, nx, ny, nz, eval_rows, inv, entry, dirs, hit,
                          ray_ids, c, seed_base, sub_first, n_samples, mean_out, m2_out,
                          count_out, work_out, sub0);
    }
    return 0;
  }
  const int64_t n_items = n * (int64_t)n_samples;
  const bool deferred = sub0 != nullptr && radiance_mode == 1;
#define DS_ITEMS(K)                                                                            \
  if (deferred) {                                                                              \
    trace_items_deferred<K>(dens, insc, nx, ny, nz, eval_rows, inv, entry, dirs, hit, ray_ids, \
                            n, n_items, c, seed_base, sub0, rec_rad, rec_work);                \
  } else {                                                                                     \
    trace_items<K>(dens, insc, nx, ny, nz, eval_rows, inv, entry, dirs, hit, ray_ids, n,       \
                   n_items, c, seed_base, sub_first, sub0, rec_rad, rec_work);                 \
  }
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

// The rays in chunks of G lanes: each chunk's lanes computed one after the
// other into arrays (what the card's shuffles and ballots deliver).
// One chunk of ray R on G lanes with skip Skip, the lanes computed one
// after the other into arrays (what the card's shuffles and ballots
// deliver); stop_at_cross as chunk_end's.
template <int G, int Skip, typename T>
void lane_chunk(ds::Ray& R, const T* dens, int nx, int ny, int nz, const ds::MarchConsts& c,
                bool stop_at_cross) {
  ds::LaneStep S[G];
  ds::LaneSkip F[G] = {};
  for (int l = 0; l < G; ++l) {
    S[l] = Skip == ds::kSkipNone
               ? ds::lane_step<G>(R, l, dens, nx, ny, nz, c)
               : ds::lane_step_skip<G, Skip>(R, l, dens, nx, ny, nz, c, skip_args, F[l]);
  }
  for (int l = 0; l < G; ++l) {
    S[l].tn = ds::lane_transmittance<G>(R.trans, l, [&](int k) { return S[k].e; });
  }
  unsigned leaves = 0u, crosses = 0u, cuts = 0u, empties = 0u;
  for (int l = 0; l < G; ++l) {
    leaves |= (unsigned)ds::lane_leaves(S[l], c) << l;
    crosses |= (unsigned)ds::lane_crosses(R, S[l]) << l;
    cuts |= (unsigned)F[l].cut << l;
    empties |= (unsigned)F[l].empty << l;
  }
  bool jump = false;
  const ds::ChunkEnd E =
      Skip == ds::kSkipNone
          ? ds::chunk_end(leaves, crosses, c.max_steps - R.steps, G, stop_at_cross)
          : ds::chunk_end_skip(leaves, crosses, cuts, empties, c.max_steps - R.steps, G,
                               stop_at_cross, jump);
  ds::chunk_update(R, E, [&](int k) { return S[k]; });
  if (jump) ds::chunk_jump(R, nx, ny, nz, c);
}

// lane_chunk with the running skip.
template <int G, typename T>
void lane_chunk_skip(ds::Ray& R, const T* dens, int nx, int ny, int nz,
                     const ds::MarchConsts& c, bool stop_at_cross) {
  switch (skip_mode) {
    case ds::kSkipCell:
      lane_chunk<G, ds::kSkipCell>(R, dens, nx, ny, nz, c, stop_at_cross);
      break;
    case ds::kSkipBlock:
      lane_chunk<G, ds::kSkipBlock>(R, dens, nx, ny, nz, c, stop_at_cross);
      break;
    default:
      lane_chunk<G, ds::kSkipNone>(R, dens, nx, ny, nz, c, stop_at_cross);
  }
}

template <int G, typename T>
void march_chunks(const T* dens, const T* insc, int nx, int ny, int nz, const float* eval_rows,
                  const float* entry, const float* dirs, const int64_t* ray_ids,
                  const float* trans_total, uint32_t seed, int64_t n, const ds::MarchConsts& c,
                  float* t_out, float* pos_out, uint8_t* ok_out, float* direct_out,
                  unsigned long long* counters) {
  for (int64_t r = 0; r < n; ++r) {
    ds::Ray R;
    ds::ray_begin(R, r, entry, dirs, ray_ids, trans_total, seed, c);
    while (R.active) {
      counters[0] += G;  // lane-step slots
      lane_chunk_skip<G>(R, dens, nx, ny, nz, c, false);
    }
    counters[1] += (unsigned long long)R.steps;
    ds::ray_end(R, r, insc, nx, ny, nz, eval_rows, c, t_out, pos_out, ok_out, direct_out);
  }
}

template <typename T>
int march(const T* dens, const T* insc, int nx, int ny, int nz, const float* eval_rows,
          const float* entry, const float* dirs, const int64_t* ray_ids,
          const float* trans_total, uint32_t seed, int64_t n, const ds::MarchConsts& c,
          float* t_out, float* pos_out, uint8_t* ok_out, float* direct_out,
          unsigned long long* counters) {
  if (march_mode == 0) {
    if (skip_mode != ds::kSkipNone) return -1;  // the per-ray loop takes no skip
    for (int64_t r = 0; r < n; ++r) {
      ds::march_ray(r, dens, insc, nx, ny, nz, eval_rows, entry, dirs, ray_ids, trans_total,
                    seed, c, t_out, pos_out, ok_out, direct_out);
    }
    return 0;
  }
#define DS_CHUNKS(G)                                                                       \
  march_chunks<G>(dens, insc, nx, ny, nz, eval_rows, entry, dirs, ray_ids, trans_total, seed, \
                  n, c, t_out, pos_out, ok_out, direct_out, counters)
  if (march_lanes == 1) {
    DS_CHUNKS(1);
  } else if (march_lanes == 8) {
    DS_CHUNKS(8);
  } else if (march_lanes == 32) {
    DS_CHUNKS(32);
  } else {
    return -1;
  }
#undef DS_CHUNKS
  return 0;
}

template <typename T>
void descriptor(const T* mips, const float* pos, const float* dirs, const float* frames,
                const float* ez, const float* light, int64_t m, const ds::DescConsts& c,
                float* out) {
  if (desc_mode == 0) {
    const int64_t total = m * c.n_layers * ds::kRowWidth;
    for (int64_t g = 0; g < total; ++g) {
      out[g] = ds::descriptor_element(g, mips, pos, dirs, frames, ez, light, c);
    }
    return;
  }
  for (int p = 0; p < (int)m; ++p) {
    const ds::PointFrame F =
        ds::point_frame(ez, frames[3 * p], frames[3 * p + 1], frames[3 * p + 2]);
    for (int col = 0; col < ds::kRowWidth; ++col) {
      ds::descriptor_column(p, col, mips, pos, dirs, light, c, F, out);
    }
  }
}

// Attempt R marched in chunks of G lanes (a chunk's lanes one after the
// other), with chunk_end's stop at the crossing.
template <int G, typename T>
void attempt_chunks(ds::Ray& R, const T* dens, int nx, int ny, int nz, const ds::MarchConsts& c) {
  while (R.active) lane_chunk_skip<G>(R, dens, nx, ny, nz, c, true);
}

// K7a's first design: each sample's attempts in order, each attempt in
// chunks of G lanes.
template <int G, typename T>
void sample_chunks(const T* dens, int nx, int ny, int nz, uint32_t seed, int64_t n,
                   const ds::MarchConsts& c, float min_dist, float* pos_out, float* dir_out,
                   uint8_t* found_out, int32_t* work_out) {
  for (int64_t s = 0; s < n; ++s) {
    ds::Ray R;
    bool found = false;
    int k = 0, steps = 0;
    while (!found && k < ds::kMaxAttempts) {
      ds::attempt_start(R, ds::attempt_ray(seed, (uint32_t)s, k, c, min_dist), c);
      ++k;
      attempt_chunks<G>(R, dens, nx, ny, nz, c);
      steps += R.steps;
      found = ds::accepted(R, c);
    }
    ds::sample_end(s, found, R, c, k, steps, pos_out, dir_out, found_out, work_out);
  }
}

// K7a's kernel: each sample's attempts in rounds of W (attempt first + w
// by "warp" w, in chunks of 32 lanes), each round closed by round_end.
template <typename T>
void sample_rounds(int W, const T* dens, int nx, int ny, int nz, uint32_t seed, int64_t n,
                   const ds::MarchConsts& c, float min_dist, float* pos_out, float* dir_out,
                   uint8_t* found_out, int32_t* work_out) {
  std::vector<ds::Ray> R(W);
  std::vector<int> steps_w(W);
  for (int64_t s = 0; s < n; ++s) {
    int steps = 0;
    bool done = false;
    for (int first = 0; first < ds::kMaxAttempts && !done; first += W) {
      unsigned accepted = 0u;
      for (int w = 0; w < W; ++w) {
        steps_w[w] = 0;
        if (first + w >= ds::kMaxAttempts) continue;
        ds::attempt_start(R[w], ds::attempt_ray(seed, (uint32_t)s, first + w, c, min_dist), c);
        attempt_chunks<32>(R[w], dens, nx, ny, nz, c);
        steps_w[w] = R[w].steps;
        if (ds::accepted(R[w], c)) accepted |= 1u << w;
      }
      const ds::RoundEnd E = ds::round_end(first, W, accepted, steps_w.data());
      steps += E.steps;
      if (E.winner >= 0) {
        ds::sample_end(s, true, R[E.winner - first], c, E.winner + 1, steps, pos_out, dir_out,
                       found_out, work_out);
        done = true;
      }
    }
    if (!done) {
      ds::sample_end(s, false, R[0], c, ds::kMaxAttempts, steps, pos_out, dir_out, found_out,
                     work_out);
    }
  }
}

// Attempt R marched by one thread (attempt_chunk_jump at lookahead K) with
// the running launch's face exit: by product where every cell count is a
// power of two (kSkipCellPow2), else from the face table (kSkipCell).
template <int K, typename T>
void attempt_thread(ds::Ray& R, const T* dens, int nx, int ny, int nz, const ds::MarchConsts& c) {
  if (pow2_grid) {
    const auto jump = ds::face_exit_of<true>(face_table.data(), nx, ny, c.bbox, c.step, skip_args);
    while (R.active) ds::attempt_chunk_jump<K>(R, dens, nx, ny, nz, c, jump);
  } else {
    const auto jump = ds::face_exit_of<false>(face_table.data(), nx, ny, c.bbox, c.step, skip_args);
    while (R.active) ds::attempt_chunk_jump<K>(R, dens, nx, ny, nz, c, jump);
  }
}

// K7a's cell-jump kernel: each sample's attempts in rounds of A, attempt
// first + l on "lane" l marched to its end by attempt_thread, each round
// closed by round_end (the kernel drops the work past the winner, which
// changes no value).
template <typename T>
void sample_threads(int A, const T* dens, int nx, int ny, int nz, uint32_t seed, int64_t n,
                    const ds::MarchConsts& c, float min_dist, float* pos_out, float* dir_out,
                    uint8_t* found_out, int32_t* work_out) {
  std::vector<ds::Ray> R(A);
  std::vector<int> steps_l(A);
  for (int64_t s = 0; s < n; ++s) {
    int steps = 0;
    bool done = false;
    for (int first = 0; first < ds::kMaxAttempts && !done; first += A) {
      unsigned accepted = 0u;
      for (int l = 0; l < A; ++l) {
        steps_l[l] = 0;
        if (first + l >= ds::kMaxAttempts) continue;
        ds::attempt_start(R[l], ds::attempt_ray(seed, (uint32_t)s, first + l, c, min_dist), c);
        attempt_thread<ds::kAttemptLookahead>(R[l], dens, nx, ny, nz, c);
        steps_l[l] = R[l].steps;
        if (ds::accepted(R[l], c)) accepted |= 1u << l;
      }
      const ds::RoundEnd E = ds::round_end(first, A, accepted, steps_l.data());
      steps += E.steps;
      if (E.winner >= 0) {
        ds::sample_end(s, true, R[E.winner - first], c, E.winner + 1, steps, pos_out, dir_out,
                       found_out, work_out);
        done = true;
      }
    }
    if (!done) {
      ds::sample_end(s, false, R[0], c, ds::kMaxAttempts, steps, pos_out, dir_out, found_out,
                     work_out);
    }
  }
}

template <typename T>
int samples(const T* dens, int nx, int ny, int nz, uint32_t seed, int64_t n,
            const ds::MarchConsts& c, float min_dist, float* pos_out, float* dir_out,
            uint8_t* found_out, int32_t* work_out) {
  if (samples_mode == 0) {
    if (skip_mode != ds::kSkipNone) return -1;  // the per-sample loop takes no skip
    for (int64_t s = 0; s < n; ++s) {
      ds::sample_attempts(s, dens, nx, ny, nz, seed, c, min_dist, pos_out, dir_out, found_out,
                          work_out);
    }
    return 0;
  }
  if (samples_mode == 3) {
    if (skip_mode != ds::kSkipCell) return -1;
    sample_threads(ds::kAttemptGroup, dens, nx, ny, nz, seed, n, c, min_dist, pos_out, dir_out,
                   found_out, work_out);
    return 0;
  }
  if (samples_mode == 2) {
    if (samples_warps < 1 || samples_warps > 32) return -1;
    sample_rounds(samples_warps, dens, nx, ny, nz, seed, n, c, min_dist, pos_out, dir_out,
                  found_out, work_out);
    return 0;
  }
#define DS_SAMPLES(G) \
  sample_chunks<G>(dens, nx, ny, nz, seed, n, c, min_dist, pos_out, dir_out, found_out, work_out)
  if (samples_lanes == 1) {
    DS_SAMPLES(1);
  } else if (samples_lanes == 8) {
    DS_SAMPLES(8);
  } else if (samples_lanes == 32) {
    DS_SAMPLES(32);
  } else {
    return -1;
  }
#undef DS_SAMPLES
  return 0;
}

// group_deposit over arrays of G lanes: runs of equal keys numbered by
// their first lanes, the segmented scan level by level (the same additions
// in the same tree order), the last lane of each run adding its sums to
// the texels idx_of(lane) of a float32 or float64 grid (a negative key
// adds nothing).
template <int G, class I, typename T>
void host_deposit(const int* key, float (*v)[8], I idx_of, T* grid) {
  const ds::diff::AddTo add;
  int run[G];
  bool head[G];
  for (int l = 0, n_run = 0; l < G; ++l) {
    head[l] = l == 0 || key[l - 1] != key[l];
    n_run += head[l] ? 1 : 0;
    run[l] = n_run;
  }
  for (int o = 1; o < G; o <<= 1) {
    float prev[G][8];
    for (int l = 0; l < G; ++l) {
      for (int k = 0; k < 8; ++k) prev[l][k] = v[l][k];
    }
    for (int l = o; l < G; ++l) {
      if (run[l - o] != run[l]) continue;
      for (int k = 0; k < 8; ++k) v[l][k] = v[l][k] + prev[l - o][k];
    }
  }
  for (int l = 0; l < G; ++l) {
    if (key[l] < 0 || !(l == G - 1 || head[l + 1])) continue;
    const int* idx = idx_of(l);
    for (int k = 0; k < 8; ++k) add(grid + idx[k], v[l][k]);
  }
}

// v[l][3] summed over the lanes as the kernels' shuffle tree sums them
// into lane 0.
template <int G>
void host_group_sum3(float (*v)[3], float* out) {
  for (int o = G / 2; o > 0; o >>= 1) {
    for (int l = 0; l < o; ++l) {
      for (int a = 0; a < 3; ++a) v[l][a] += v[l + o][a];
    }
  }
  for (int a = 0; a < 3; ++a) out[a] = v[0][a];
}

// The sun march from q in chunks of G lanes (csrc/diff_variants.cu's
// sun_march_lanes): each
// chunk's lanes one after the other into arrays, the span from their
// in-box bits, tau folded in step order.
template <int G>
float sun_march_chunks(const float* dens, const ds::diff::Grid3& g, float step, float dm, int n,
                       const float* q, const float* ts, int* n_in) {
  float tau = 0.0f;
  bool was_in = false;
  int count = 0;
  for (int j0 = 0; j0 < n; j0 += G) {
    float xs[G];
    unsigned in = 0u;
    for (int l = 0; l < G; ++l) {
      float s, u[3];
      xs[l] = 0.0f;
      if (j0 + l < n && ds::diff::sun_point(g, step, q, ts, j0 + l, &s, u)) {
        xs[l] = (ds::trilinear_strided(dens, g.nx, g.ny, g.nz, u[0], u[1], u[2]) * dm) * step;
        in |= 1u << l;
      }
    }
    const ds::diff::LaneSpan sp = ds::diff::lane_span(in, was_in, G);
    for (int l = 0; l < G; ++l) {
      if (l < sp.start || l >= sp.end) xs[l] = 0.0f;
    }
    tau = ds::diff::lane_sum<G>(tau, [&](int k) { return xs[k]; });
    count += sp.end - sp.start;
    was_in = was_in || sp.start < sp.end;
    if (sp.ended) break;
  }
  *n_in = count;
  return expf(-tau);
}

// The sun march's adjoint in chunks of G lanes (sun_march_adjoint_lanes):
// the density scatters summed over runs of lanes in one cell
// (host_deposit), d/dq and d/d to_sun summed over the lanes at the end.
template <int G>
void sun_march_adjoint_chunks(const float* dens, const ds::diff::Grid3& g, float step, float dm,
                              int n, const float* q, const float* ts, float T, float gT,
                              float* d_dens, float* dq_out, float* dts_out) {
  float dq[G][3] = {}, dts[G][3] = {};
  const float drho = ((-(gT * T)) * step) * dm;
  bool was_in = false;
  for (int j0 = 0; drho != 0.0f && j0 < n; j0 += G) {
    ds::diff::Taps t[G];
    float s[G];
    unsigned in = 0u;
    for (int l = 0; l < G; ++l) {
      float u[3];
      if (j0 + l < n && ds::diff::sun_point(g, step, q, ts, j0 + l, &s[l], u)) {
        t[l] = ds::diff::taps_at(g, u[0], u[1], u[2]);
        in |= 1u << l;
      }
    }
    const ds::diff::LaneSpan sp = ds::diff::lane_span(in, was_in, G);
    float v[G][8] = {};
    int key[G];
    for (int l = 0; l < G; ++l) {
      key[l] = -1 - l;
      if (l < sp.start || l >= sp.end) continue;
      for (int k = 0; k < 8; ++k) v[l][k] = drho * t[l].w[k];
      float dp[3];
      ds::diff::taps_point_slope(dens, g, t[l], drho, dp);
      for (int a = 0; a < 3; ++a) {
        dq[l][a] += dp[a];
        dts[l][a] += dp[a] * s[l];
      }
      key[l] = t[l].idx[0];
    }
    host_deposit<G>(key, v, [&](int l) { return t[l].idx; }, d_dens);
    was_in = was_in || sp.start < sp.end;
    if (sp.ended) break;
  }
  host_group_sum3<G>(dq, dq_out);
  host_group_sum3<G>(dts, dts_out);
}

// K8b's forward for ray (e, d) in chunks of G lanes (march_lanes_kernel):
// every lane's density sample, the span from their in-box bits, tau before
// each lane and after the chunk (lane_sum), the lit lanes' segments and
// in-scatter (pointwise: each lit lane's own sun march), the radiance
// folded in step order; counts as march_ray's.
template <int G>
float march_fwd_chunks(const float* dens, const float* baked, const ds::diff::MarchConsts& c,
                       const float* ts, const float* e, const float* d, float ph, int* counts) {
  float tau = 0.0f, R = 0.0f;
  bool was_in = false;
  int n_in = 0, n_lit = 0, n_sun = 0;
  for (int i0 = 0; i0 < c.n_steps; i0 += G) {
    ds::diff::Step st[G];
    unsigned in = 0u;
    for (int l = 0; l < G; ++l) {
      if (i0 + l < c.n_steps && ds::diff::step_sigma(dens, c, e, d, i0 + l, st[l])) {
        in |= 1u << l;
      }
    }
    const ds::diff::LaneSpan sp = ds::diff::lane_span(in, was_in, G);
    float xs[G], tau_l[G], term[G];
    for (int l = 0; l < G; ++l) {
      xs[l] = l >= sp.start && l < sp.end ? st[l].sigma * c.step : 0.0f;
    }
    auto xs_of = [&](int k) { return xs[k]; };
    float tau_next = tau;
    for (int l = 0; l < G; ++l) {
      tau_next = ds::diff::lane_sum<G>(tau, l, xs_of, &tau_l[l]);
    }
    tau = tau_next;
    for (int l = 0; l < G; ++l) {
      term[l] = 0.0f;
      if (l < sp.start || l >= sp.end || st[l].sigma == 0.0f) continue;
      ++n_lit;
      ds::diff::step_segment(c, e, d, st[l]);
      int ns;
      ds::diff::Taps tq;
      const float S = ds::diff::t_sun_at<true>(dens, baked, c, ts, st[l].q, &tq, &ns);
      n_sun += ns;
      term[l] = (((expf(-tau_l[l]) * st[l].seg) * S) * ph) * c.sun_ratio;
    }
    R = ds::diff::lane_sum<G>(R, [&](int k) { return term[k]; });
    n_in += sp.end - sp.start;
    was_in = was_in || sp.start < sp.end;
    if (sp.ended) break;
  }
  counts[0] = n_in;
  counts[1] = n_lit;
  counts[2] = n_sun;
  return R;
}

// K8b's adjoint for ray r in chunks of G lanes: each chunk's lanes
// computed one after the other into arrays (what the card's ballot and
// shuffles deliver), the grid scatters summed over runs of lanes in one
// cell as group_deposit's segmented scan sums them (the same additions, in
// the same tree order), the group's sums of d/d entry, dirs and to_sun as
// the kernel's shuffle tree.
template <int G>
float march_bwd_chunks(const float* dens, const float* baked, const ds::diff::MarchConsts& c,
                       const float* ts, const float* e, const float* d, float ph, float R,
                       float g, float* d_dens, float* d_baked, float* de_out, float* dd_out,
                       float* dts_out) {
  const ds::diff::AddTo add;
  float de[G][3] = {}, dd[G][3] = {}, dts[G][3] = {};
  float tau = 0.0f, C = 0.0f, dP = 0.0f;
  bool was_in = false;
  for (int i0 = 0; i0 < c.n_steps; i0 += G) {
    ds::diff::LaneDiff L[G];
    unsigned in = 0u;
    for (int l = 0; l < G; ++l) {
      ds::diff::lane_sample(dens, baked, c, ts, e, d, i0 + l, L[l]);
      in |= (unsigned)L[l].in << l;
    }
    const ds::diff::LaneSpan sp = ds::diff::lane_span(in, was_in, G);
    float xs[G], term[G], dterm[G], tau_l[G], C_l[G];
    for (int l = 0; l < G; ++l) {
      const bool mine = l >= sp.start && l < sp.end;
      xs[l] = mine ? L[l].st.sigma * c.step : 0.0f;
    }
    auto sig_of = [&](int k) { return xs[k]; };
    float tau_next = tau;
    for (int l = 0; l < G; ++l) tau_next = ds::diff::lane_sum<G>(tau, l, sig_of, &tau_l[l]);
    tau = tau_next;
    for (int l = 0; l < G; ++l) {
      term[l] = dterm[l] = 0.0f;
      if (l >= sp.start && l < sp.end) {
        L[l].st.tv = expf(-tau_l[l]);
        const float tvseg = L[l].st.tv * L[l].st.seg;
        term[l] = ((tvseg * L[l].S) * ph) * c.sun_ratio;
        dterm[l] = (tvseg * L[l].S) * c.sun_ratio;
      }
    }
    auto term_of = [&](int k) { return term[k]; };
    float C_next = C;
    for (int l = 0; l < G; ++l) {
      C_next = ds::diff::lane_sum<G>(C, l, term_of, &C_l[l]);
      C_l[l] = C_l[l] + term[l];
    }
    C = C_next;
    dP = ds::diff::lane_sum<G>(dP, [&](int k) { return dterm[k]; });
    float vd[G][8] = {}, vb[G][8] = {};
    int key_d[G], key_b[G];
    bool lit_any = false;
    for (int l = 0; l < G; ++l) {
      key_d[l] = key_b[l] = -1 - l;
      if (l < sp.start || l >= sp.end) continue;
      ds::diff::step_adjoint(dens, baked, c, ts, d, ph, R, g, L[l].st, L[l].S, L[l].tq, C_l[l],
                             d_dens, vd[l], vb[l], de[l], dd[l], dts[l], add);
      key_d[l] = L[l].st.tp.idx[0];
      bool lit = false;
      for (int k = 0; k < 8; ++k) lit = lit || vb[l][k] != 0.0f;
      if (c.baked && lit) key_b[l] = L[l].tq.idx[0];
      lit_any = lit_any || lit;
    }
    if (c.baked && lit_any) {
      host_deposit<G>(key_b, vb, [&](int l) { return L[l].tq.idx; }, d_baked);
    }
    host_deposit<G>(key_d, vd, [&](int l) { return L[l].st.tp.idx; }, d_dens);
    was_in = was_in || sp.start < sp.end;
    if (sp.ended) break;
  }
  for (int o = G / 2; o > 0; o >>= 1) {
    for (int l = 0; l < o; ++l) {
      for (int a = 0; a < 3; ++a) {
        de[l][a] += de[l + o][a];
        dd[l][a] += dd[l + o][a];
        dts[l][a] += dts[l + o][a];
      }
    }
  }
  for (int a = 0; a < 3; ++a) {
    de_out[a] = de[0][a];
    dd_out[a] = dd[0][a];
    dts_out[a] = dts[0][a];
  }
  return dP * g;
}

// K8c's sweep of work-list entry e with G lanes, the lanes computed one
// after the other into arrays: on a flight's chunks of G steps
// (remarch_lane, the density scatters summed over runs of lanes in one cell
// as group_deposit sums them); the slope sums in the kernel's shuffle tree;
// the flights' scalar part (flight_head) once, with NEE's eight texels (the
// card's lanes add them between them).  The light gradients are added to
// sums.
template <int G>
void sweep_lanes(const ds::path::PathArgs& a, int64_t e, double* sums) {
  const ds::diff::AddTo add;
  const int64_t i = e >> 32;
  const int flights = (int)(e & 0xffffffff);
  const ds::path::SweepItem it = ds::path::sweep_item(a, i);
  const ds::path::Segment* seg = a.seg + i * (int64_t)a.max_segments;
  float xb[3] = {0.0f, 0.0f, 0.0f}, wb[3] = {0.0f, 0.0f, 0.0f};
  ds::path::LightGrads L = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  int remarched = 0;
  for (int d = flights - 1; d >= 0; --d) {
    const ds::path::Segment& g = seg[d];
    float c0, cK;
    if (!ds::path::flight_head(a, g, g.s, it, xb, wb, c0, cK, L, 0, 1, add)) continue;
    remarched += g.steps;
    double sx[G][3] = {}, sw[G][3] = {};
    float q[3] = {g.x[0], g.x[1], g.x[2]};
    for (int j0 = 0; j0 < g.steps; j0 += G) {
      float p[G][3], v[G][8];
      int idx[G][8], key[G];
      for (int l = 0; l < G; ++l) {
        const bool on = ds::path::remarch_lane<G>(a.dens, a.gr, a.c, g.w, g.steps, q, j0, l, c0,
                                                  cK, p[l], idx[l], v[l], sx[l], sw[l]);
        key[l] = on ? idx[l][0] : -1 - l;
      }
      host_deposit<G>(key, v, [&](int l) { return idx[l]; }, a.d_dens);
      for (int t = 0; t < 3; ++t) q[t] = p[G - 1][t];
    }
    for (int o = G / 2; o > 0; o >>= 1) {
      for (int l = 0; l < o; ++l) {
        for (int t = 0; t < 3; ++t) {
          sx[l][t] += sx[l + o][t];
          sw[l][t] += sw[l + o][t];
        }
      }
    }
    for (int t = 0; t < 3; ++t) {
      xb[t] += (float)sx[0][t];
      wb[t] += (float)sw[0][t];
    }
  }
  float de[3], dd[3];
  ds::path::sweep_tail(a, it, xb, wb, de, dd);
  for (int t = 0; t < 3; ++t) {
    a.d_entry[3 * it.item + t] = de[t];
    a.d_dirs[3 * it.item + t] = dd[t];
    sums[t] += (double)L.dir[t];
    sums[3 + t] += (double)L.rad[t];
  }
  if (a.remarch != nullptr) a.remarch[it.item] = remarched;
}

// K9 in the design host_set_spatial chose, a ray at a time in ray order
// (the rays are independent; the kernel's scan order changes nothing).
template <int G, typename T>
void spatial_rays(const ds::spatial::SlabArgs<T>& a) {
  for (int64_t r = 0; r < a.n; ++r) ds::spatial::ray_phase<G>(a, r);
}

template <typename T>
void spatial_phase(const void* dens, const void* insc, int nx, int ny, int nz, int z0,
                   int slab, int halo, const float* eval_rows, const float* inv_rows,
                   const ds::PtConsts& c, uint32_t seed, const int64_t* ids, int64_t n,
                   int steps, const float* rec_in, float* rec_out) {
  if (spatial_design == 0) {
    const ds::spatial::SlabZ zm{z0 - halo, slab + 2 * halo - 1};
    for (int64_t r = 0; r < n; ++r) {
      ds::spatial::phase_ray(r, (const T*)dens, (const T*)insc, nx, ny, nz, z0, slab, zm,
                             eval_rows, inv_rows, c, seed, ids, steps, rec_in, rec_out);
    }
    return;
  }
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
  a.scan = 1;
  a.chunks = ds::spatial::kSpatialChunks;
  a.rec_in = rec_in;
  a.rec_out = rec_out;
  a.counters = nullptr;
  memcpy(rec_out, rec_in, (size_t)n * ds::spatial::kWidth * sizeof(float));
  switch (spatial_lanes) {
    case 4: spatial_rays<4>(a); break;
    case 8: spatial_rays<8>(a); break;
    case 16: spatial_rays<16>(a); break;
    case 32: spatial_rays<32>(a); break;
    default: spatial_rays<1>(a); break;
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

// mode 0: march_ray a ray; mode 1: chunks of `lanes` lanes (1, 8 or 32; 0
// for the kernel's kMarchLanes).
void host_set_march(int mode, int lanes) {
  march_mode = mode;
  march_lanes = lanes > 0 ? lanes : ds::kMarchLanes;
}

// mode 0: descriptor_element an element; mode 1: descriptor_column a
// column.
void host_set_descriptor(int mode) { desc_mode = mode; }

// mode 0: probe_channel an element (K5's first design); mode 1:
// probe_word a word (its redesign).
void host_set_probes(int mode) { probes_mode = mode; }

// mode 0: sample_attempts a sample; mode 1: each attempt in chunks of
// `lanes` lanes (1, 8 or 32) in order; mode 2: rounds of `lanes` attempts
// (W, 1 to 32), each in chunks of 32 lanes.
void host_set_samples(int mode, int lanes) {
  samples_mode = mode;
  if (mode == 2) {
    samples_warps = lanes;
  } else {
    samples_lanes = lanes;
  }
}

// K7b where host_set_pathtrace's mode is 1: mode 0 K4's items, mode 1 a
// warp with deferred scatters resolved at `park_at` parked lanes (0: the
// kernel's kParkAt).
void host_set_radiance(int mode, int park_at) {
  radiance_mode = mode;
  radiance_park_at = park_at > 0 ? park_at : ds::kParkAt;
}

// The cell jump of K4 and K7b: design 0 the first (a jump ends its
// chunk), 1 the kernels' (the jump inside the chunk, the faces by product
// or from the face table by the grid), 2 the jump inside the chunk with
// the first design's exit, 3 the faces from the table on every grid.
void host_set_jump(int design) { jump_design = design; }

// K4's block skip: design 0 the first (the float32 occupancy at every
// step), 1 the kernels' (march_steps_block on the bits, with the density
// certificate).
void host_set_block(int design) { block_design = design; }

// The occupancy reads of the last block-skip launch of design 1.
int64_t host_block_reads() { return block_reads; }

// The face table of an [nz, ny, nx] grid of box edges bbox[3]
// (skip.cuh::face_table_entry) into out [face_table_size].
void host_face_table(int nx, int ny, int nz, const float* bbox, float* out) {
  for (int i = 0; i < ds::face_table_size(nx, ny, nz); ++i) {
    out[i] = ds::face_table_entry(i, nx, ny, nz, bbox);
  }
}

// The cell jump's whole steps from n points p [n, 3] (local coordinates)
// along d [n, 3] with room[n] lattice steps left, in the cell the taps
// find there: design 0 by cell_exit_steps (the first design's), 1 by the
// kernels' FaceExit (by product where every cell count is a power of two,
// else from the table), 3 by FaceExit from the table.
void host_exit_steps(int design, int64_t n, int nx, int ny, int nz, const float* bbox,
                     float step, const float* p, const float* d, const int32_t* room,
                     float* out) {
  fill_face_table(nx, ny, nz, bbox);
  const ds::SkipArgs sk = ds::cell_recips(ds::SkipArgs{}, nx, ny, nz, step);
  const auto table = ds::face_exit_of<false>(face_table.data(), nx, ny, bbox, step, sk);
  const auto product = ds::face_exit_of<true>(face_table.data(), nx, ny, bbox, step, sk);
  const bool by_product = design == 1 && pow2_grid;
  float inv[3];
  for (int a = 0; a < 3; ++a) inv[a] = ds::pow2_recip(bbox[a]);
  for (int64_t i = 0; i < n; ++i) {
    const float* q = p + 3 * i;
    const float* v = d + 3 * i;
    const float ux = ds::div_exact(q[0], bbox[0], inv[0]);
    const float uy = ds::div_exact(q[1], bbox[1], inv[1]);
    const float uz = ds::div_exact(q[2], bbox[2], inv[2]);
    if (design == 0) {
      out[i] = ds::cell_exit_steps(nx, ny, nz, bbox, step, ux, uy, uz, q[0], q[1], q[2], v[0],
                                   v[1], v[2], room[i]);
    } else {
      const int cx = ds::axis_cell(ux * (float)nx - 0.5f, nx).i0;
      const int cy = ds::axis_cell(uy * (float)ny - 0.5f, ny).i0;
      const int cz = ds::axis_cell(uz * (float)nz - 0.5f, nz).i0;
      out[i] = by_product
                   ? product(cx, cy, cz, ux, uy, uz, q[0], q[1], q[2], v[0], v[1], v[2], room[i])
                   : table(cx, cy, cz, ux, uy, uz, q[0], q[1], q[2], v[0], v[1], v[2], room[i]);
    }
  }
}

// K8a: adjoint 0 bake_adjoint_voxel a voxel, 1 bake_adjoint_row a row.
// K8b's adjoint: march 0 march_ray_adjoint a ray, 1 chunks of `lanes`
// lanes (1, 8 or 32; 0 for the kernel's kDiffLanes).
void host_set_diff(int adjoint, int march, int lanes) {
  adjoint_mode = adjoint;
  diff_mode = march;
  diff_lanes = lanes > 0 ? lanes : ds::diff::kDiffLanes;
}

// K8b's forward: march 0 march_ray a ray, 1 chunks of `lanes` lanes (1, 8
// or 32; 0 for the kernel's kDiffLanes); the sun march and its adjoint:
// sun 0 a point at a time (the first designs), 1 chunks of `sun_lanes` (1,
// 8 or 32; 0 for 8), 2 a point at a time (the kernels').
void host_set_diff_forward(int march, int lanes, int sun, int sun_lanes_) {
  fwd_mode = march;
  fwd_lanes = lanes > 0 ? lanes : ds::diff::kDiffLanes;
  sun_mode = sun;
  sun_lanes = sun_lanes_ > 0 ? sun_lanes_ : 8;
}

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
  for (int i = 0; i < 4; ++i) counters[i] = 0;
  counters[0] = (unsigned long long)(n * n_samples);
  if (is_u8) {
    return pathtrace((const uint8_t*)dens, (const uint8_t*)insc, nx, ny, nz, eval_rows,
                     inv_rows, entry, dirs, hit, ray_ids, n, c, seed_base, sub_first, nullptr,
                     n_samples, rec_rad, rec_work, mean_out, m2_out, count_out, work_out);
  }
  return pathtrace((const float*)dens, (const float*)insc, nx, ny, nz, eval_rows, inv_rows,
                   entry, dirs, hit, ray_ids, n, c, seed_base, sub_first, nullptr, n_samples,
                   rec_rad, rec_work, mean_out, m2_out, count_out, work_out);
}

int ds_radiance(const void* dens, const void* insc, int is_u8, int nx, int ny, int nz,
                const float* eval_rows, int n_phase, const float* inv_rows, int n_inv,
                const float* entry, const float* dirs, const uint8_t* hit,
                const int64_t* ray_ids, int64_t n, const float* consts, const float* ground,
                int max_steps, int max_depth, int rr_start, int flags, uint32_t seed_base,
                const uint32_t* sub0, int n_samples, float* rec_rad, int32_t* rec_work,
                unsigned long long* counters, float* mean_out, float* m2_out,
                float* count_out, int64_t* work_out, void* /*stream*/) {
  if (n <= 0) return 0;
  if (sub0 == nullptr) return 1;
  const ds::PtConsts c =
      ds::pt_consts(consts, ground, max_steps, max_depth, rr_start, n_phase, n_inv, flags);
  for (int i = 0; i < 4; ++i) counters[i] = 0;
  counters[0] = (unsigned long long)(n * n_samples);
  if (is_u8) {
    return pathtrace((const uint8_t*)dens, (const uint8_t*)insc, nx, ny, nz, eval_rows,
                     inv_rows, entry, dirs, hit, ray_ids, n, c, seed_base, 0u, sub0,
                     n_samples, rec_rad, rec_work, mean_out, m2_out, count_out, work_out);
  }
  return pathtrace((const float*)dens, (const float*)insc, nx, ny, nz, eval_rows, inv_rows,
                   entry, dirs, hit, ray_ids, n, c, seed_base, 0u, sub0, n_samples, rec_rad,
                   rec_work, mean_out, m2_out, count_out, work_out);
}

// The *_skip entry points: their base's work with skip_mode and skip_args
// set for the call (DS_SKIP_PARAMS; the kernels' checks of the skip).
int ds_pathtrace_skip(const void* dens, const void* insc, int is_u8, int nx, int ny, int nz,
                      const float* eval_rows, int n_phase, const float* inv_rows, int n_inv,
                      const float* entry, const float* dirs, const uint8_t* hit,
                      const int64_t* ray_ids, int64_t n, const float* consts,
                      const float* ground, int max_steps, int max_depth, int rr_start,
                      int flags, uint32_t seed_base, uint32_t sub_first, int n_samples,
                      float* rec_rad, int32_t* rec_work, unsigned long long* counters,
                      float* mean_out, float* m2_out, float* count_out, int64_t* work_out,
                      void* stream, DS_SKIP_PARAMS) {
  if ((skip != ds::kSkipCell && skip != ds::kSkipBlock) || jumped == nullptr ||
      (skip == ds::kSkipBlock && (occ == nullptr || occ_bits == nullptr))) {
    return 1;
  }
  for (int64_t i = 0; i < n; ++i) jumped[i] = 0;
  skip_mode = skip;
  skip_args = ds::cell_recips(DS_SKIP_ARGS, nx, ny, nz, consts[3]);
  fill_face_table(nx, ny, nz, consts);
  block_reads = 0;
  const int err = ds_pathtrace(dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase, inv_rows,
                               n_inv, entry, dirs, hit, ray_ids, n, consts, ground, max_steps,
                               max_depth, rr_start, flags, seed_base, sub_first, n_samples,
                               rec_rad, rec_work, counters, mean_out, m2_out, count_out,
                               work_out, stream);
  skip_mode = ds::kSkipNone;
  return err;
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
  if (skip != ds::kSkipCell || jumped == nullptr) return 1;
  for (int64_t i = 0; i < n; ++i) jumped[i] = 0;
  skip_mode = skip;
  skip_args = ds::cell_recips(DS_SKIP_ARGS, nx, ny, nz, consts[3]);
  fill_face_table(nx, ny, nz, consts);
  const int err = ds_radiance(dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase, inv_rows,
                              n_inv, entry, dirs, hit, ray_ids, n, consts, ground, max_steps,
                              max_depth, rr_start, flags, seed_base, sub0, n_samples, rec_rad,
                              rec_work, counters, mean_out, m2_out, count_out, work_out,
                              stream);
  skip_mode = ds::kSkipNone;
  return err;
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

// ds_bake over the planes [z_begin, z_end) only (bake_voxel or bake_row as
// host_set_bake chose).
int ds_bake_planes(const void* dens, int is_u8, int nx, int ny, int nz, const float* consts,
                   int n_steps, int early_out, int z_begin, int z_end, float* out,
                   void* /*stream*/) {
  if (z_begin < 0 || z_end > nz || z_begin > z_end) return 1;
  const ds::BakeConsts c = ds::bake_consts(consts);
  const int64_t plane = (int64_t)nx * ny;
  std::vector<float> rows(4 * (size_t)nx);
  for (int z = z_begin; z < z_end; ++z) {
    for (int y = 0; y < ny; ++y) {
      float* row = out + (int64_t)(z - z_begin) * plane + (int64_t)y * nx;
      for (int x = 0; x < nx && bake_mode == 0; ++x) {
        const int64_t v = z * plane + (int64_t)y * nx + x;
        row[x] = is_u8 ? ds::bake_voxel(v, (const uint8_t*)dens, nx, ny, nz, c, n_steps, early_out)
                       : ds::bake_voxel(v, (const float*)dens, nx, ny, nz, c, n_steps, early_out);
      }
      if (bake_mode == 0) continue;
      if (is_u8) {
        ds::bake_row(y, z, (const uint8_t*)dens, nx, ny, nz, c, n_steps, early_out, rows.data(),
                     row);
      } else {
        ds::bake_row(y, z, (const float*)dens, nx, ny, nz, c, n_steps, early_out, rows.data(),
                     row);
      }
    }
  }
  return 0;
}

// K9 (ds_spatial_phase's arguments; n_alive is the kernel's choice of lanes
// and changes nothing here; no warp iterations are counted).
int ds_spatial_phase(const void* dens, const void* insc, int is_u8, int nx, int ny, int nz,
                     int z0, int slab, int halo, const float* eval_rows, int n_phase,
                     const float* inv_rows, int n_inv, const float* consts, const float* ground,
                     int max_depth, int rr_start, int flags, uint32_t seed, const int64_t* ids,
                     int64_t n, int64_t /*n_alive*/, int steps, const float* rec_in,
                     float* rec_out, unsigned long long* counters, void* /*stream*/) {
  counters[0] = (unsigned long long)n;  // every ray scanned
  counters[1] = 0;
  const ds::PtConsts c =
      ds::pt_consts(consts, ground, 0, max_depth, rr_start, n_phase, n_inv, flags);
  if (is_u8) {
    spatial_phase<uint8_t>(dens, insc, nx, ny, nz, z0, slab, halo, eval_rows, inv_rows, c, seed,
                           ids, n, steps, rec_in, rec_out);
  } else {
    spatial_phase<float>(dens, insc, nx, ny, nz, z0, slab, halo, eval_rows, inv_rows, c, seed,
                         ids, n, steps, rec_in, rec_out);
  }
  return 0;
}

int ds_march_lanes() { return ds::kMarchLanes; }

int ds_march(const void* dens, const void* insc, int is_u8, int nx, int ny, int nz,
             const float* eval_rows, int n_phase, const float* entry, const float* dirs,
             const int64_t* ray_ids, const float* trans_total, uint32_t seed, int64_t n,
             const float* consts, int max_steps, float* t_out, float* pos_out,
             uint8_t* ok_out, float* direct_out, unsigned long long* counters,
             void* /*stream*/) {
  counters[0] = 0;
  counters[1] = 0;
  const ds::MarchConsts c = ds::march_consts(consts, max_steps, n_phase);
  if (is_u8) {
    return march((const uint8_t*)dens, (const uint8_t*)insc, nx, ny, nz, eval_rows, entry,
                 dirs, ray_ids, trans_total, seed, n, c, t_out, pos_out, ok_out, direct_out,
                 counters);
  }
  return march((const float*)dens, (const float*)insc, nx, ny, nz, eval_rows, entry, dirs,
               ray_ids, trans_total, seed, n, c, t_out, pos_out, ok_out, direct_out, counters);
}

int ds_march_skip(const void* dens, const void* insc, int is_u8, int nx, int ny, int nz,
                  const float* eval_rows, int n_phase, const float* entry, const float* dirs,
                  const int64_t* ray_ids, const float* trans_total, uint32_t seed, int64_t n,
                  const float* consts, int max_steps, float* t_out, float* pos_out,
                  uint8_t* ok_out, float* direct_out, unsigned long long* counters,
                  void* stream, DS_SKIP_PARAMS) {
  if (skip != ds::kSkipBlock || occ == nullptr) return 1;
  skip_mode = skip;
  skip_args = DS_SKIP_ARGS;
  const int err = ds_march(dens, insc, is_u8, nx, ny, nz, eval_rows, n_phase, entry, dirs,
                           ray_ids, trans_total, seed, n, consts, max_steps, t_out, pos_out,
                           ok_out, direct_out, counters, stream);
  skip_mode = ds::kSkipNone;
  return err;
}

int ds_descriptor(const void* mips, int is_u8, const float* pos, const float* dirs,
                  const float* frames, const float* ez, const float* light, int64_t m,
                  int n_layers, int n_levels, const float* fconsts, const int64_t* iconsts,
                  float* out, void* /*stream*/) {
  if (!ds::desc_args_ok(m, n_layers, n_levels)) return 1;
  const ds::DescConsts c = ds::desc_consts(fconsts, iconsts, n_layers, n_levels);
  if (is_u8) {
    descriptor((const uint8_t*)mips, pos, dirs, frames, ez, light, m, c, out);
  } else {
    descriptor((const float*)mips, pos, dirs, frames, ez, light, m, c, out);
  }
  return 0;
}

// K5: probe_point a point, then probe_channel its 202 elements (mode 0)
// or probe_word its 50 latent words and the angles (mode 1).
int ds_probes(const void* probes, int is_u8, int nx, int ny, int nz, const float* pos,
              const float* dirs, const float* ez, const float* light, int64_t n,
              const float* consts, float* out, void* /*stream*/) {
  const ds::ProbeConsts c = ds::probe_consts(consts, nx, ny, nz);
  for (int p = 0; p < (int)n; ++p) {
    const ds::ProbePoint P = ds::probe_point(p, pos, dirs, ez, light, c);
    float* row = out + (int64_t)p * ds::kProbeInWidth;
    if (probes_mode == 0) {
      for (int ch = 0; ch < ds::kProbeInWidth; ++ch) {
        row[ch] = is_u8 ? ds::probe_channel(P, ch, (const uint8_t*)probes)
                        : ds::probe_channel(P, ch, (const float*)probes);
      }
      continue;
    }
    for (int w = 0; w < ds::kProbeLength / 4; ++w) {
      if (is_u8) {
        ds::probe_word(P, w, (const uint8_t*)probes, row + 4 * w);
      } else {
        ds::probe_word(P, w, (const float*)probes, row + 4 * w);
      }
    }
    row[ds::kProbeLength] = P.omega;
    row[ds::kProbeLength + 1] = P.alpha;
  }
  return 0;
}

// The package's K7a warps a sample and K7b parked lanes (the constants the
// kernels run).
int ds_sample_warps() { return ds::kSampleWarps; }
int ds_radiance_park_at() { return ds::kParkAt; }

// K7a (mode set by host_set_samples).
int ds_samples(const void* dens, int is_u8, int nx, int ny, int nz, uint32_t seed, int64_t n,
               const float* consts, int max_steps, float min_dist,
               float* pos_out, float* dir_out, uint8_t* found_out, int32_t* work_out,
               void* /*stream*/) {
  const ds::MarchConsts c = ds::march_consts(consts, max_steps, 0);
  if (is_u8) {
    return samples((const uint8_t*)dens, nx, ny, nz, seed, n, c, min_dist, pos_out, dir_out,
                   found_out, work_out);
  }
  return samples((const float*)dens, nx, ny, nz, seed, n, c, min_dist, pos_out, dir_out,
                 found_out, work_out);
}

int ds_samples_skip(const void* dens, int is_u8, int nx, int ny, int nz, uint32_t seed,
                    int64_t n, const float* consts, int max_steps, float min_dist,
                    float* pos_out, float* dir_out, uint8_t* found_out, int32_t* work_out,
                    void* stream, DS_SKIP_PARAMS) {
  if (skip != ds::kSkipCell && (skip != ds::kSkipBlock || occ == nullptr)) return 1;
  skip_mode = skip;
  skip_args = ds::cell_recips(DS_SKIP_ARGS, nx, ny, nz, consts[9]);
  fill_face_table(nx, ny, nz, consts);
  const int err = ds_samples(dens, is_u8, nx, ny, nz, seed, n, consts, max_steps, min_dist,
                             pos_out, dir_out, found_out, work_out, stream);
  skip_mode = ds::kSkipNone;
  return err;
}

// K10: every output element of a batch row through assemble_value; an
// index outside [0, n) gives a row of NaN.
static void assemble_row(const uint8_t* row, int n_out, int width, float omega, float* out) {
  for (int j = 0; j < n_out; ++j) out[j] = ds::assemble_value(row, j, width, omega);
}

int ds_assemble_disney(const void* grids, const float* omega, const float* labels, int64_t n,
                       const int64_t* idx, int b, int layers, float* z, float* lab,
                       void* /*stream*/) {
  const int in_bytes = layers * ds::kAssembleLayer;
  const int out_n = layers * (ds::kAssembleLayer + 1);
  for (int i = 0; i < b; ++i) {
    float* out = z + (int64_t)i * out_n;
    const int64_t r = idx[i];
    if (r < 0 || r >= n) {
      for (int j = 0; j < out_n; ++j) out[j] = NAN;
      lab[i] = NAN;
      continue;
    }
    assemble_row((const uint8_t*)grids + r * in_bytes, out_n, ds::kAssembleLayer + 1, omega[r],
                 out);
    lab[i] = labels[r];
  }
  return 0;
}

int ds_assemble_baked(const void* probes, const void* rt, const float* powers,
                      const float* omega, const float* alpha, const float* labels, int64_t n,
                      const int64_t* idx, int b, int probe_layers, int rt_layers,
                      float* probe_out, float* rt_out, float* powers_out, float* omega_out,
                      float* alpha_out, float* lab, void* /*stream*/) {
  const int probe_n = 4 * probe_layers * ds::kAssembleLayer;
  const int rt_bytes = rt_layers * ds::kAssembleLayer;
  const int rt_n = rt_layers * (ds::kAssembleLayer + 1);
  for (int i = 0; i < b; ++i) {
    float* pout = probe_out + (int64_t)i * probe_n;
    float* rout = rt_out + (int64_t)i * rt_n;
    const int64_t r = idx[i];
    if (r < 0 || r >= n) {
      for (int j = 0; j < probe_n; ++j) pout[j] = NAN;
      for (int j = 0; j < rt_n; ++j) rout[j] = NAN;
      for (int k = 0; k < 4; ++k) powers_out[(int64_t)i * 4 + k] = NAN;
      omega_out[i] = alpha_out[i] = lab[i] = NAN;
      continue;
    }
    assemble_row((const uint8_t*)probes + r * probe_n, probe_n, ds::kAssembleLayer, omega[r],
                 pout);
    assemble_row((const uint8_t*)rt + r * rt_bytes, rt_n, ds::kAssembleLayer + 1, omega[r],
                 rout);
    for (int k = 0; k < 4; ++k) powers_out[(int64_t)i * 4 + k] = powers[r * 4 + k];
    omega_out[i] = omega[r];
    alpha_out[i] = alpha[r];
    lab[i] = labels[r];
  }
  return 0;
}

// K8a, K8b and the sun march: the device functions over every item, one
// after the other.  K8a's light gradient: per-voxel, summed a block of
// kDiffThreads voxels into each partial row (the first design); per-row, a
// row's voxels summed in float64 into the row's partial.
int64_t ds_bake_adjoint_blocks(int nx, int ny, int nz) {
  const int64_t rows = ds::diff::row_launch(nx, ny, nz, ds::diff::kAdjVoxels).blocks;
  const int64_t voxels = ((int64_t)nx * ny * nz + ds::diff::kDiffThreads - 1) /
                         ds::diff::kDiffThreads;
  return rows > voxels ? rows : voxels;
}

int ds_bake_adjoint(const float* dens, int nx, int ny, int nz, const float* consts,
                    int n_steps, const float* trans, const float* gbar, double* d_dens,
                    double* partials, void* /*stream*/) {
  const int64_t n = (int64_t)nx * ny * nz;
  const ds::diff::AdjConsts c = ds::diff::adj_consts(nx, ny, nz, consts);
  if (adjoint_mode == 1) {
    std::vector<ds::diff::AdjVoxel> vox(nx);
    for (int row = 0; row < ny * nz; ++row) {
      ds::diff::bake_adjoint_row(row % ny, row / ny, dens, c, n_steps, trans + (int64_t)row * nx,
                                 gbar + (int64_t)row * nx, vox.data(), d_dens,
                                 partials + 3 * (int64_t)row);
    }
    return 0;
  }
  for (int64_t b = 0; b * ds::diff::kDiffThreads < n; ++b) {
    float acc[3] = {0.0f, 0.0f, 0.0f};
    for (int64_t v = b * ds::diff::kDiffThreads;
         v < n && v < (b + 1) * ds::diff::kDiffThreads; ++v) {
      float dl[3] = {0.0f, 0.0f, 0.0f};
      ds::diff::bake_adjoint_voxel(v, dens, c, n_steps, trans[v], gbar[v], d_dens, dl);
      for (int a = 0; a < 3; ++a) acc[a] += dl[a];
    }
    for (int a = 0; a < 3; ++a) partials[3 * b + a] = acc[a];
  }
  return 0;
}

int ds_diff_march(const float* dens, const float* baked, const float* to_sun, int nx, int ny,
                  int nz, const float* consts, int n_steps, int sun_steps, const float* entry,
                  const float* dirs, const float* phase, const uint8_t* hit, int64_t n,
                  float* rad, int* steps, void* /*stream*/) {
  const ds::diff::MarchConsts c =
      ds::diff::march_consts(nx, ny, nz, consts, n_steps, sun_steps, baked != nullptr);
  for (int64_t r = 0; r < n; ++r) {
    int counts[3] = {0, 0, 0};
    rad[r] = 0.0f;
    if (hit[r]) {
      const float ts0[3] = {0.0f, 0.0f, 0.0f};
      const float* ts = baked ? ts0 : to_sun;
      const float *e = entry + 3 * r, *d = dirs + 3 * r;
#define DS_CHUNKS(G) march_fwd_chunks<G>(dens, baked, c, ts, e, d, phase[r], counts)
      if (fwd_mode == 0) {
        rad[r] = ds::diff::march_ray(dens, baked, c, ts, e, d, phase[r], counts);
      } else if (fwd_lanes == 1) {
        rad[r] = DS_CHUNKS(1);
      } else if (fwd_lanes == 8) {
        rad[r] = DS_CHUNKS(8);
      } else if (fwd_lanes == 32) {
        rad[r] = DS_CHUNKS(32);
      } else {
        return -1;
      }
#undef DS_CHUNKS
    }
    if (steps != nullptr) {
      for (int k = 0; k < 3; ++k) steps[3 * r + k] = counts[k];
    }
  }
  return 0;
}

int ds_diff_march_bwd(const float* dens, const float* baked, const float* to_sun, int nx,
                      int ny, int nz, const float* consts, int n_steps, int sun_steps,
                      const float* entry, const float* dirs, const float* phase,
                      const uint8_t* hit, const float* rad, const float* g_rad, int64_t n,
                      float* d_dens, float* d_baked, float* d_entry, float* d_dirs,
                      float* d_phase, float* d_ts, void* /*stream*/) {
  const ds::diff::MarchConsts c =
      ds::diff::march_consts(nx, ny, nz, consts, n_steps, sun_steps, baked != nullptr);
  for (int64_t r = 0; r < n; ++r) {
    float de[3] = {0.0f, 0.0f, 0.0f}, dd[3] = {0.0f, 0.0f, 0.0f}, dts[3] = {0.0f, 0.0f, 0.0f};
    float dphase = 0.0f;
    if (hit[r] && g_rad[r] != 0.0f) {
      const float ts0[3] = {0.0f, 0.0f, 0.0f};
      const float* ts = baked ? ts0 : to_sun;
      const float *e = entry + 3 * r, *d = dirs + 3 * r;
#define DS_CHUNKS(G)                                                                        \
  march_bwd_chunks<G>(dens, baked, c, ts, e, d, phase[r], rad[r], g_rad[r], d_dens, d_baked, de, \
                      dd, dts)
      if (diff_mode == 0) {
        dphase = ds::diff::march_ray_adjoint(dens, baked, c, ts, e, d, phase[r], rad[r], g_rad[r],
                                             d_dens, d_baked, de, dd, dts, ds::diff::AddTo());
      } else if (diff_lanes == 1) {
        dphase = DS_CHUNKS(1);
      } else if (diff_lanes == 8) {
        dphase = DS_CHUNKS(8);
      } else if (diff_lanes == 32) {
        dphase = DS_CHUNKS(32);
      } else {
        return -1;
      }
#undef DS_CHUNKS
    }
    for (int a = 0; a < 3; ++a) {
      d_entry[3 * r + a] = de[a];
      d_dirs[3 * r + a] = dd[a];
      if (d_ts != nullptr) d_ts[3 * r + a] = dts[a];
    }
    d_phase[r] = dphase;
  }
  return 0;
}

int ds_sun_march(const float* dens, const float* to_sun, int nx, int ny, int nz,
                 const float* consts, int n_steps, const float* pos, int64_t n, float* out,
                 int* steps, void* /*stream*/) {
  const ds::diff::Grid3 g = ds::diff::grid3(nx, ny, nz, consts);
  for (int64_t r = 0; r < n; ++r) {
    int n_in;
    const float* q = pos + 3 * r;
#define DS_CHUNKS(G) sun_march_chunks<G>(dens, g, consts[3], consts[4], n_steps, q, to_sun, &n_in)
    if (sun_mode == 0) {
      out[r] = ds::diff::sun_march(dens, g, consts[3], consts[4], n_steps, q, to_sun, &n_in);
    } else if (sun_mode == 2) {
      out[r] = ds::diff::sun_march<true>(dens, g, consts[3], consts[4], n_steps, q, to_sun, &n_in);
    } else if (sun_lanes == 1) {
      out[r] = DS_CHUNKS(1);
    } else if (sun_lanes == 8) {
      out[r] = DS_CHUNKS(8);
    } else if (sun_lanes == 32) {
      out[r] = DS_CHUNKS(32);
    } else {
      return -1;
    }
#undef DS_CHUNKS
    if (steps != nullptr) steps[r] = n_in;
  }
  return 0;
}

int ds_sun_march_bwd(const float* dens, const float* to_sun, int nx, int ny, int nz,
                     const float* consts, int n_steps, const float* pos, const float* trans,
                     const float* g_trans, int64_t n, float* d_dens, float* d_pos, float* d_ts,
                     void* /*stream*/) {
  const ds::diff::Grid3 g = ds::diff::grid3(nx, ny, nz, consts);
  for (int64_t r = 0; r < n; ++r) {
    float dq[3] = {0.0f, 0.0f, 0.0f}, dts[3] = {0.0f, 0.0f, 0.0f};
    const float* q = pos + 3 * r;
#define DS_CHUNKS(G)                                                                          \
  sun_march_adjoint_chunks<G>(dens, g, consts[3], consts[4], n_steps, q, to_sun, trans[r], \
                              g_trans[r], d_dens, dq, dts)
    if (sun_mode == 0 || sun_mode == 2) {
      const ds::diff::AddTo add;
      if (sun_mode == 0) {
        ds::diff::sun_march_adjoint<false>(dens, g, consts[3], consts[4], n_steps, q, to_sun,
                                           trans[r], g_trans[r], d_dens, dq, dts, add);
      } else {
        ds::diff::sun_march_adjoint<true>(dens, g, consts[3], consts[4], n_steps, q, to_sun,
                                          trans[r], g_trans[r], d_dens, dq, dts, add);
      }
    } else if (sun_lanes == 1) {
      DS_CHUNKS(1);
    } else if (sun_lanes == 8) {
      DS_CHUNKS(8);
    } else if (sun_lanes == 32) {
      DS_CHUNKS(32);
    } else {
      return -1;
    }
#undef DS_CHUNKS
    for (int a = 0; a < 3; ++a) {
      d_pos[3 * r + a] = dq[a];
      d_ts[3 * r + a] = dts[a];
    }
  }
  return 0;
}

// K8c (path_design and path_lanes as host_set_path chose): its light
// gradients summed in float64 into partial row 0 (its only row); counters:
// the items, the work list's front length, 0, its back length.
int64_t ds_path_pixel_bytes(int n_samples, int max_segments) {
  return ds::path::pixel_bytes(n_samples, max_segments);
}

int64_t ds_path_adjoint_blocks(int64_t /*m*/, int /*n_samples*/) { return 1; }

int ds_path_adjoint(const float* dens, const float* insc, int nx, int ny, int nz,
                    const float* eval_rows, int n_phase, const float* inv_rows, int n_inv,
                    const float* entry, const float* dirs, const uint8_t* hit,
                    const int64_t* ray_ids, int64_t n, int64_t r0, int64_t m,
                    const float* consts, const float* ground, int max_steps, int max_depth,
                    int rr_start, int flags, uint32_t seed_base, uint32_t sub_first,
                    int n_samples, const float* g_rec, void* scratch, int max_segments,
                    unsigned long long* counters, float* rec_rad, int32_t* rec_work,
                    double* d_dens, double* d_insc, float* d_entry, float* d_dirs,
                    int32_t* remarch, double* partials, void* /*stream*/) {
  ds::path::PathArgs a;
  if (!ds::path::path_args(&a, dens, insc, nx, ny, nz, eval_rows, n_phase, inv_rows, n_inv,
                           entry, dirs, hit, ray_ids, n, r0, m, consts, ground, max_steps,
                           max_depth, rr_start, flags, seed_base, sub_first, n_samples, g_rec,
                           scratch, max_segments, counters, rec_rad, rec_work, d_dens, d_insc,
                           d_entry, d_dirs, remarch, partials)) {
    return -1;
  }
  double sums[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  path_list.clear();
  front_length = 0;
  if (path_design == 0) {
    for (int64_t i = 0; i < a.n_items; ++i) {
      ds::path::LightGrads L = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
      ds::path::adjoint_item(a, i, L, ds::diff::AddTo());
      for (int t = 0; t < 3; ++t) {
        sums[t] += L.dir[t];
        sums[3 + t] += L.rad[t];
      }
    }
  } else {
    std::vector<int64_t> back;
    for (int64_t t = 0; t < a.n_items; ++t) {
      const int64_t i = path_order ? path_order[t] : t;
      ds::Sample S;
      int64_t item;
      if (!ds::path::replay_begin(a, i, S, item)) continue;
      int flights = 0, steps0 = 0, rsteps = 0;
      while (!ds::path::replay_chunk<ds::kLookahead>(a, i, S, flights, steps0, rsteps)) {
      }
      if (ds::path::replay_end(a, S, item)) {
        (rsteps >= path_long_steps ? path_list : back).push_back(ds::path::list_entry(i, flights));
      }
    }
    front_length = (int64_t)path_list.size();
    path_list.insert(path_list.end(), back.begin(), back.end());
    for (const int64_t e : path_list) {
      if (path_lanes == 1) {
        sweep_lanes<1>(a, e, sums);
      } else if (path_lanes == 8) {
        sweep_lanes<8>(a, e, sums);
      } else if (path_lanes == 32) {
        sweep_lanes<32>(a, e, sums);
      } else {
        return -1;
      }
    }
  }
  counters[0] = (unsigned long long)a.n_items;
  counters[1] = (unsigned long long)front_length;
  counters[2] = 0;
  counters[3] = (unsigned long long)(path_list.size() - front_length);
  for (int t = 0; t < 6; ++t) partials[t] = sums[t];
  return 0;
}

// K8c: design 0 adjoint_item an item (its first design), 1 (or -1) the
// replay and the sweep with `lanes` lanes a sample (1, 8 or 32; 0 for the
// kernel's kSweepLanes), the replay's items in `order` (NULL: in item
// order), the list's front taking the samples that re-march at least
// `long_steps` steps (-1 for the kernel's kLongSteps).
void host_set_path(int design, int lanes, const int64_t* order, int long_steps) {
  path_design = design == 0 ? 0 : 1;
  path_lanes = lanes > 0 ? lanes : ds::path::kSweepLanes;
  path_order = order;
  path_long_steps = long_steps >= 0 ? long_steps : ds::path::kLongSteps;
}

// The last design-1 launch's work list in the sweep's order, its front then
// its back (up to cap entries into out, item i << 32 | flights); returns
// its length.
int64_t host_path_list(int64_t* out, int64_t cap) {
  const int64_t len = (int64_t)path_list.size();
  for (int64_t t = 0; t < len && t < cap; ++t) out[t] = path_list[t];
  return len;
}

// K9: design 0 phase_ray a ray (its first design), 1 the kernel's group of
// `lanes` lanes a ray (1, 4, 8, 16 or 32).
void host_set_spatial(int design, int lanes) {
  spatial_design = design == 0 ? 0 : 1;
  spatial_lanes = lanes;
}

}  // extern "C"
