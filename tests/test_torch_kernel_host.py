"""K4 (path-trace bounce loop), K3 (in-scatter bake), K9 (slab march), K1 (camera march),
K2 (descriptor stencil), K5 (probe interpolation), K7a (first-scatter
sampler), K7b (radiance experiments), K10 (batch assembly), K8a (the
differentiable bake's adjoint), K8b (the quadrature march and the sun
march, forward and adjoint) and K8c (the path tracer's adjoint) on the
host.

``tests/torch_kernel_host.cpp`` compiles the kernels' device functions
(``csrc/pathtrace.cu``, ``csrc/inscatter.cu``, ``csrc/march.cu``,
``csrc/descriptor.cu``, ``csrc/probes.cu``) with g++ under ``-DDS_HOST_EMULATION`` into a
library with the device entry points' signatures; the wrappers' ``_launch``
drives it on CPU tensors.  What the warp-level queue, shuffles and ballots
and the block-level staging leave to the device is not here: this pins the
arithmetic the kernels share with their host build.

- K4's work items (pixel, sample) traced in a shuffled order into per-sample
  records and then folded equal, bitwise, the per-pixel loop
  ``pathtrace_pixel``; so does the march for K = 1 and the kernel's
  lookahead K, also with a step cap that cuts samples inside a chunk.
- K3's row formulation ``bake_row`` equals the per-voxel ``bake_voxel``,
  bitwise, on a 20 x 28 x 36 grid, for four sun directions, with early-out
  on and off, on both texture types.
- K1's chunked march (G lanes a ray, a chunk's lanes emulated one after the
  other; G = 1, 8 (the kernel's ``kMarchLanes``) and 32) equals the per-ray loop
  ``march_ray`` bitwise in both passes, on the 48^3 cumulus and a
  20 x 28 x 36 grid (whose box is not a power of two: IEEE divisions), for
  every camera ray (box misses included), rays that start outside the box
  or miss the cloud AABB, and axis-parallel rays; also with a step cap that
  ends rays inside a chunk, and with crossings placed on a chunk's first and
  last lanes.  Its step counter equals the plain version's steps.
- K2's column formulation ``descriptor_column`` equals the per-element
  ``descriptor_element`` bitwise for every (point, layer, column), on both
  grids and texture types, at points inside and outside the box; also at
  the baked renderer's 3 layers and 9 layers in the probe direction's frame.
- K5's ``probe_point`` and ``probe_channel`` equal the plain version
  bitwise on the interpolated latents (the float expressions are IEEE
  products, sums, a division and a square root), on float32 and uint8
  lattices, at points inside and outside the box and on the tetrahedra's
  test planes; omega and alpha within 1e-6 (glibc's ``acosf``).
- K5's redesign (``probe_word``: 4 channels from a word of each corner
  row) equals its first design (``probe_channel`` an element) bitwise on
  every column, over float32 and uint8 lattices.
- K7a's rounds (W attempts at once, ``round_end`` picking the smallest
  accepted one and the steps of the attempts up to it; W = 1, 3, 8 (the
  kernel's ``kSampleWarps``) and 32) equal the per-sample attempt loop
  ``sample_attempts`` bitwise (positions, directions, found, attempts,
  steps) on a thin cloud where samples need up to 256 attempts: samples
  that scatter only in their last round of 256 attempts and samples that
  never scatter included.
- K7a's chunked attempts (G = 1, 8 and 32 lanes, ``chunk_end`` stopping at
  the crossing) equal the per-sample attempt loop ``sample_attempts``
  bitwise (positions, directions, found, attempts, steps), on both grids
  and texture types; against the plain version (glibc's ``sinf``/``cosf``
  are not torch's, and a flipped attempt moves a sample) found flags agree
  on >= 99.5 % of samples, and where the attempts agree (>= 95 %)
  positions are within 1e-4 and directions within 1e-6.
- K7b's deferred scatters (a warp of 32 lanes that parks each crossing
  and resolves the parked ones together, ``resolve_now`` at 1, 20 = the
  kernel's ``kParkAt`` and 32 parked lanes) equal K4's item loop (its first
  design) bitwise, records and folds, for items in item order, shuffled
  and point-major, also with a step cap that cuts samples inside a chunk.
- K7b's per-pixel experiment bases: each pixel of a ``ds_radiance`` launch
  equals a ``ds_pathtrace`` launch of that pixel alone with ``sub_first``
  set to its base, bitwise, with bases within a few experiments of 2^32
  (``sub0 + k`` wraps), and the work items equal the per-pixel loop; the
  wrapper's per-point moments equal the plain version's counts.
- K10's element ``assemble_value`` over every output of a batch row equals
  the plain version (``index_select``, ``true_div`` by 256, ``cat``)
  bitwise, in both layouts, for rows in any order, repeated rows and a
  batch of one; an index outside the table gives a row of NaN.
- K8b's forward (``march_ray``) within 1e-6 of the plain march's largest
  value in both in-scatter modes, 0 on rays that miss, stopping at the box
  exit (its step counts); its adjoint (the kernel's lanes) within 1e-5 of
  autograd of the plain march for the density, the baked grid or the sun
  direction, the entries, directions and phase values, and on the 8
  deepest rays within 1e-4 of each ray's largest (the R - prefix replay);
  finite on axis-parallel rays and exactly 0 on rays that miss.  K8a
  (``bake_adjoint_row``, float64 sums) within 1e-6 of autograd of the
  plain bake (float64 sums over the steps too), the light gradient within
  1e-5.  The sun march and its adjoint within 1e-6 and 1e-5.  The render's
  autograd Functions over the host build within 1e-6 (image), 1e-5
  (density) and 1e-4 (the other leaves) of the plain render.
- K8a's row form (``bake_adjoint_row``: the row's y/z work once a step,
  each voxel's runs of steps in one cell, their float32 sums added in
  float64) equals its per-voxel first design ``bake_adjoint_voxel``
  within float64 rounding (1e-12 of the density gradient's largest value:
  the same float32 terms summed in another order; measured 1.2e-15) on
  the 20 x 28 x 36 grid, for four light directions (one axis-parallel),
  with every face's texels reached; the light gradient (its slope
  regrouped) within 1e-6 (measured 1.4e-7).
- K8b's adjoint in chunks of G lanes a ray (``lane_span``, ``lane_sum``,
  ``step_adjoint``, the grid scatters summed over runs of lanes in one
  cell) equals its per-ray first design ``march_ray_adjoint`` bitwise at
  G = 1 and within 1e-5 of each leaf's largest at G = 8 and 32 (the
  kernel's two; measured: at most 8.0e-7, d/d to_sun; 4.7e-7 the
  density's), on the 24^3 cumulus of ``test_torch_cuda_kernels.py``,
  baked and pointwise.
- K8b's forward in chunks of G lanes a ray (``step_sigma``,
  ``lane_span``, ``lane_sum``; pointwise each lit lane's own sun march)
  equals its per-ray first design ``march_ray`` bitwise in the radiance
  and the three step counts at G = 1, 8 and 32, baked and pointwise, with
  each ray's first step in the box on a chunk's lane 0, 7 or 31 and with a
  cap of 45 steps inside a chunk.  The kernels' sun march, a thread a point
  (strided samples), and the lane form of ``csrc/diff_variants.cu`` in
  chunks of G lanes a point equal ``sun_march`` bitwise in T and the
  samples in the box (points entering the box on the way, a cap of 45
  steps inside a chunk, and the main path's 128); their adjoints (the
  thread's merged runs; ``group_deposit``'s runs) within 1e-5 of
  ``sun_march_adjoint``'s largest value of each output, bitwise at G = 1.
- K8c in each design: its kernels' (the replay over the items in order
  and shuffled, each sample to its end with K4's ``march_steps`` and
  ``resolve`` at ``kLookahead``, appending the work list, its front the
  samples that may re-march the most; then the sweep over the list with
  G = 1, 8 (the kernel's) and 32 lanes a sample, the lanes computed one
  after the other: ``flight_head``, then each flight's re-march on chunks
  of G steps (``remarch_lane``, the density scatters merged over runs of
  lanes as ``group_deposit`` merges them, or each lane's added alone) or
  on contiguous blocks of its steps (``remarch_block``), the slope sums in
  the kernel's shuffle tree) and its first design (``adjoint_item``: a thread an item, the
  replay at lookahead 1, then the sweep re-marching each flight) against
  autograd of the plain paths (``diff.path_records_plain``) for a random
  upstream, at ``test_diff_cross_validation.py``'s gradient point in
  all-scatter, multiple-scatter and single-scatter mode and all-scatter
  with ``sample_sky`` and roulette (``rr_start_depth`` 2, ``rr_survival``
  0.8): the density within 1e-5 of its largest value, the in-scatter,
  light direction and radiance, entries and directions within 1e-4, and
  on the 16 paths with the most steps d/d entry and d/d dirs within 1e-4
  of each path's largest; its replayed records equal K4's bitwise.  The
  work list holds exactly the samples with a nonzero upstream and a
  recorded flight, with their flights.  Launches split under a scratch
  budget change nothing but float64 rounding; and the render's autograd
  Functions over the host build (K3, K4, K8c, K8a) match the plain render
  within 1e-6 (image), 1e-5 (density) and 1e-4.
- K9 (``csrc/spatial.cu``, ``ray_phase`` a ray at one lane a ray; its
  groups of lanes and its first design in ``test_torch_k9_host.py``) on 1,
  2 and 4 z-slabs of the grid, each phase a launch a slab merged by the
  masked sum of
  ``parallel.spatial_render.owner_merge`` (one owner a ray), equals K4's
  per-pixel loop ``pathtrace_pixel`` bitwise in the three modes on both
  texture types; on 2 slabs every phase's records equal the plain version
  ``spatial_phase_plain``'s in depth, alive, touched and steps, the rest
  within 1e-5 of each column's largest value (at least 1).  K3's plane
  range (``ds_bake_planes``) over an uneven split equals ``ds_bake``
  bitwise, and so do the plain version's planes.
- All match the plain PyTorch versions within the tolerances of
  ``test_torch_cuda_kernels.py``: glibc's ``expf``/``logf``/``sinf``/
  ``cosf``/``acosf`` are not torch's, so step counts agree on >= 99 % of
  pixels (mean within 1e-5, m2 within 1e-4 of their largest values there),
  the bake within 1e-5 (quantized values on all but 0.1 % of voxels), the
  march's T within 1e-5 (scatter flags on >= 99.5 % of rays, positions
  within 1e-4 where both scatter) and the descriptor within 1e-5.  The path
  tracer is held there at ``max_depth`` 10: over tens of bounces the
  ulps of the two libraries' direction samples move NEE taps with the
  step counts still equal (measured at ``max_depth`` 40 in the
  multiple-scatter mode: 9.2e-5 of the image's largest mean, on 2 of 1,024
  pixels, with 45 and 88 bounces).

Skips only where g++ is absent.
"""

import ctypes
import dataclasses
import math
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from deepestscatter_tpu_torch import build_scene, config, cuda_build, with_baked_inscatter
from deepestscatter_tpu_torch.data import collectors, procedural
from deepestscatter_tpu_torch.ops import descriptor, march
from deepestscatter_tpu_torch.ops import rng as rng_ops
from deepestscatter_tpu_torch.ops import tetra
from deepestscatter_tpu_torch.render import baked, camera, diff, inscatter, pathtracer
from deepestscatter_tpu_torch.train import device_data

HOST_SOURCE = Path(__file__).with_name("torch_kernel_host.cpp")
PIXELS = 32
SAMPLES = 3
SEED = 5


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (the host build of the kernels' device functions)")
    out = tmp_path_factory.mktemp("kernel_host") / "libkernel_host.so"
    proc = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off",
         "-DDS_HOST_EMULATION", "-D__device__=", "-D__forceinline__=inline",
         f"-I{cuda_build.CSRC}", "-o", str(out), str(HOST_SOURCE)],
        capture_output=True, text=True,
    )
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(out))
    lib.host_set_pathtrace.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.host_set_bake.argtypes = [ctypes.c_int]
    lib.host_set_march.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.host_set_descriptor.argtypes = [ctypes.c_int]
    lib.host_set_probes.argtypes = [ctypes.c_int]
    lib.host_set_samples.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.host_set_radiance.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.host_set_diff.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.host_set_diff_forward.argtypes = [ctypes.c_int] * 4
    lib.host_set_path.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    lib.host_path_list.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.host_path_list.restype = ctypes.c_int64
    return lib


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _host_stream(monkeypatch):
    monkeypatch.setattr(cuda_build, "stream_handle", lambda: ctypes.c_void_p(None))


@pytest.fixture(scope="module", params=["uint8", "float32"])
def pt_rig(request):
    """The 24^3 cumulus of seed 11 at 2000 m, 32 x 32 pixels, step 1/64,
    max_depth 40, baked on the CPU; and its rays."""
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        camera=config.CameraConfig(width=PIXELS, height=PIXELS),
        rendering=config.CloudRendering(
            march_dtype=request.param, sample_step=1.0 / 64.0, max_depth=40),
    )
    params, static = build_scene(cfg, procedural.cumulus(24, seed=11), device="cpu")
    params = with_baked_inscatter(params, static, device="cpu")
    o, d = camera.generate_rays(camera.camera_basis(cfg.camera), PIXELS, PIXELS, "cpu")
    hit, t_hit = camera.intersect_box(o, d, static, params.bbox_size)
    entry = camera.entry_points(o, d, t_hit, params.bbox_size)
    return params, static, (entry, d, hit, torch.arange(o.shape[0]))


def _pt(lib, params, static, rays, mode, lookahead=0, order=None, max_steps=None):
    lib.host_set_pathtrace(mode, lookahead, None if order is None else order.ctypes.data)
    return pathtracer._launch(params, static, *rays, SEED, 1, SAMPLES, max_steps, lib=lib)


def _assert_equal(got, ref):
    for name, a, b in zip(ref._fields, got, ref):
        assert torch.equal(a, b), name


def _shuffled(rays, seed):
    n = rays[0].shape[0] * SAMPLES
    return np.random.default_rng(seed).permutation(n).astype(np.int64)


@pytest.mark.parametrize("mode", list(config.RenderMode))
def test_k4_items_in_any_order_equal_the_pixel_loop(host_lib, pt_rig, mode):
    params, static, rays = pt_rig
    static = dataclasses.replace(static, mode=mode)
    ref = _pt(host_lib, params, static, rays, 0)
    assert int(ref.bounces.sum()) > 0 and bool((~rays[2]).any())
    # lookahead 0: the kernel's.
    for lookahead, order in ((0, None), (0, _shuffled(rays, 1)), (1, _shuffled(rays, 2))):
        _assert_equal(_pt(host_lib, params, static, rays, 1, lookahead, order), ref)


def test_k4_lookahead_equals_stepwise_with_a_cap_inside_a_chunk(host_lib, pt_rig):
    """27 steps a sample: not a multiple of the kernel's lookahead."""
    params, static, rays = pt_rig
    full = _pt(host_lib, params, static, rays, 0)
    ref = _pt(host_lib, params, static, rays, 0, max_steps=27)
    assert bool((ref.steps < full.steps).any())  # the cap cut samples
    assert int(ref.steps.max()) <= SAMPLES * 27
    order = _shuffled(rays, 3)
    for lookahead in (1, 0):
        _assert_equal(_pt(host_lib, params, static, rays, 1, lookahead, order, 27), ref)


@pytest.mark.parametrize("mode", list(config.RenderMode))
def test_k4_host_build_matches_plain(host_lib, pt_rig, mode):
    params, static, rays = pt_rig
    static = dataclasses.replace(static, mode=mode, max_depth=10)
    got = _pt(host_lib, params, static, rays, 1, order=_shuffled(rays, 4))
    ref = pathtracer.scatter_loop_plain(params, static, *rays, SEED, 1, SAMPLES)
    assert torch.equal(got.count, ref.count)
    same = got.steps == ref.steps
    assert same.float().mean().item() >= 0.99
    for a, b, tol in ((got.mean, ref.mean, 1e-5), (got.m2, ref.m2, 1e-4)):
        assert (a - b)[same].abs().max().item() <= tol * (b.abs().max().item() + 1e-12)


#: Sun directions (pointing from the sun): the default, one along an axis,
#: one with every component negative, one of mixed signs.
LIGHTS = {
    "default": config.DirectionalLight().direction,
    "axis": (0.0, -1.0, 0.0),
    "negative": (-0.3, -0.45, -0.84),
    "mixed": (0.48, -0.6, 0.64),
}


def _smooth_grid() -> np.ndarray:
    """A 20 x 28 x 36 ([Z, Y, X]) grid of smooth random density."""
    rng = np.random.default_rng(7)
    raw = rng.random((20, 28, 36)).astype(np.float32)
    smooth = (raw + np.roll(raw, 1, 0) + np.roll(raw, 1, 1) + np.roll(raw, 1, 2)) / 4.0
    return np.clip(smooth * 1.5 - 0.5, 0.0, None).astype(np.float32)


@pytest.fixture(scope="module", params=["uint8", "float32"])
def bake_density(request):
    """The 20 x 28 x 36 grid (marched at step 1/128, about a third of a
    cell)."""
    return request.param, _smooth_grid()


@pytest.mark.parametrize("early_out", [True, False], ids=["early_out", "full"])
@pytest.mark.parametrize("light", list(LIGHTS))
def test_k3_row_equals_voxel(host_lib, bake_density, light, early_out):
    dtype, density = bake_density
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        light=config.DirectionalLight(direction=LIGHTS[light]),
        rendering=config.CloudRendering(march_dtype=dtype, sample_step=1.0 / 128.0),
    )
    params, static = build_scene(cfg, density, device="cpu")
    assert static.grid_shape == (20, 28, 36)
    k3 = (params.density_mips[0], static.bbox, static.light_direction, static.sample_step,
          static.density_multiplier, early_out)
    host_lib.host_set_bake(0)
    ref = inscatter.launch_bake(*k3, lib=host_lib)
    host_lib.host_set_bake(1)
    got = inscatter.launch_bake(*k3, lib=host_lib)
    assert torch.equal(got, ref)
    if early_out:  # the early-out fires
        assert bool((got * 255.0 < 1.0).any())
    plain = inscatter.sun_transmittance_plain(params, static, early_out)
    assert (got - plain).abs().max().item() <= 1e-5
    q = lambda t: torch.floor(t * 255.0) / 255.0  # noqa: E731
    assert (q(got) != q(plain)).float().mean().item() <= 1e-3


GRIDS = {"cumulus48": lambda: procedural.cumulus(48, seed=11), "grid20x28x36": _smooth_grid}


@pytest.fixture(scope="module", params=[(g, t) for g in GRIDS for t in ("uint8", "float32")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def neural_rig(request):
    """A scene at 2000 m, step 1/512, with a stand-in in-scatter field (the
    density flipped along z: kernels and plain versions read the same
    texture); every ray of a 48 x 24 camera, then four more: one from
    outside the box, one inside the box that misses the cloud AABB, and two
    axis-parallel ones through the middle."""
    grid, dtype = request.param
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        camera=config.CameraConfig(width=48, height=24),
        rendering=config.CloudRendering(march_dtype=dtype),
    )
    params, static = build_scene(cfg, GRIDS[grid](), device="cpu")
    params = params._replace(inscatter=params.density_mips[0].flip(0).contiguous())
    o, d = camera.generate_rays(camera.camera_basis(cfg.camera), 48, 24, "cpu")
    hit, t_hit = camera.intersect_box(o, d, static, params.bbox_size)
    entry = camera.entry_points(o, d, t_hit, params.bbox_size)
    b = [float(v) for v in params.bbox_size]
    extra_entry = torch.tensor([[-0.2, 0.5 * b[1], 0.5 * b[2]], [0.0, 0.0, 0.0],
                                [0.5 * b[0], 0.5 * b[1], 0.0], [0.45 * b[0], b[1], 0.55 * b[2]]])
    extra_dirs = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0],
                               [0.0, -1.0, 0.0]])
    entry = torch.cat([entry, extra_entry]).contiguous()
    dirs = torch.cat([d, extra_dirs]).contiguous()
    ids = torch.arange(entry.shape[0])
    return params, static, (entry, dirs, ids)


class _Capped:
    """``static`` with another march step cap: the C entry's ``max_steps``
    argument, which the wrappers fill from ``static.max_march_steps``."""

    def __init__(self, static, cap):
        self._static, self.max_march_steps = static, cap

    def __getattr__(self, name):
        return getattr(self._static, name)


def _march(lib, params, static, rays, mode, lanes=0, trans_total=None):
    """K1's host build: ``mode`` 0 ``march_ray``, 1 chunks of ``lanes``
    lanes (0: the kernel's); pass 2 where ``trans_total`` is given."""
    lib.host_set_march(mode, lanes)
    entry, dirs, ids = rays
    if trans_total is None:
        return march._launch(params, static, entry, dirs, 0, None, None, lib=lib)
    return march._launch(params, static, entry, dirs, SEED, ids, trans_total, lib=lib)


def _assert_march_equal(got, ref):
    for name, a, b in zip(ref._fields, got, ref):
        assert (a is None) == (b is None), name
        assert a is None or torch.equal(a, b), name


@pytest.mark.parametrize("lanes", [1, 8, 32])
def test_k1_lanes_equal_the_ray_loop(host_lib, neural_rig, lanes):
    """G = 1, 8 (the kernel's ``kMarchLanes``) and a whole warp."""
    assert host_lib.ds_march_lanes() in (1, 8, 32)
    params, static, rays = neural_rig
    ref1 = _march(host_lib, params, static, rays, 0)
    got1 = _march(host_lib, params, static, rays, 1, lanes)
    _assert_march_equal(got1, ref1)
    slots, steps = (int(v) for v in march.camera_march.last_counters)
    plain = march.next_scattering_event(params, static, torch.zeros_like(ref1.transmittance),
                                        *rays[:2])
    assert steps == int(plain.steps.sum()) and steps > 0
    assert steps <= slots < steps + lanes * rays[0].shape[0]
    assert bool((ref1.transmittance == 1.0).any()) and bool((ref1.transmittance < 1.0).any())
    ref2 = _march(host_lib, params, static, rays, 0, trans_total=ref1.transmittance)
    got2 = _march(host_lib, params, static, rays, 1, lanes, ref1.transmittance)
    _assert_march_equal(got2, ref2)
    assert bool(ref2.ok.any()) and bool((~ref2.ok).any())


@pytest.mark.parametrize("cap", [45, 100])
def test_k1_cap_inside_a_chunk(host_lib, neural_rig, cap):
    """Caps of 45 and 100 steps: neither a multiple of 8 nor of 32."""
    params, static, rays = neural_rig
    capped = _Capped(static, cap)
    full = _march(host_lib, params, static, rays, 0)
    ref = _march(host_lib, params, capped, rays, 0)
    assert bool((ref.transmittance != full.transmittance).any())  # the cap cut rays
    for lanes in (1, 8, 32):
        _assert_march_equal(_march(host_lib, params, capped, rays, 1, lanes), ref)
        ref2 = _march(host_lib, params, capped, rays, 0, trans_total=full.transmittance)
        got2 = _march(host_lib, params, capped, rays, 1, lanes, full.transmittance)
        _assert_march_equal(got2, ref2)
    plain = march.camera_march_plain(params, capped, *rays[:2])
    assert (ref.transmittance - plain.transmittance).abs().max().item() <= 1e-5


def test_k1_crossing_on_a_chunks_first_and_last_lane(host_lib, neural_rig):
    """The longest ray with 0.01 < T < 0.99, twice: od placed between T
    after steps 32 j and 32 j + 1, j >= 1 (the crossing on lane 0 of a
    chunk at G = 8 and 32), and between T after steps 32 j + 31 and
    32 j + 32, j >= 0 (its last lane at both G)."""
    params, static, rays = neural_rig
    plain = march.next_scattering_event(params, static, torch.zeros(rays[0].shape[0]),
                                        *rays[:2])
    partial = (plain.transmittance > 0.01) & (plain.transmittance < 0.99)
    r = int(torch.where(partial, plain.steps, torch.zeros_like(plain.steps)).argmax())
    one = tuple(t[r:r + 1].contiguous() for t in rays)

    def t_after(k):
        return _march(host_lib, params, _Capped(static, k), one, 0).transmittance[0]

    trans_total = []
    for lane in (0, 31):
        for s in range(lane or 32, int(plain.steps[r]) - 1, 32):
            before, after = t_after(s), t_after(s + 1)
            if float(before - after) > 1e-6:
                break
        else:
            pytest.fail(f"no step of lane {lane} with density on the ray")
        od = (before + after) / 2.0
        tt = 1.0 - (1.0 - od) / rng_ops.hash_uniform(SEED, one[2], 0)[0]  # od = 1 - u (1 - tt)
        got_od = march.conditional_optical_distance(SEED, one[2], tt.reshape(1))[0]
        assert after < got_od <= before, (lane, s)
        trans_total.append(float(tt))
    two = tuple(torch.cat([t, t]).contiguous() for t in one)
    tt = torch.tensor(trans_total, dtype=torch.float32)
    ref = _march(host_lib, params, static, two, 0, trans_total=tt)
    assert bool(ref.ok.all())
    for lanes in (8, 32):
        _assert_march_equal(_march(host_lib, params, static, two, 1, lanes, tt), ref)


def test_k1_host_build_matches_plain(host_lib, neural_rig):
    params, static, rays = neural_rig
    got1 = _march(host_lib, params, static, rays, 1)
    ref1 = march.camera_march_plain(params, static, *rays[:2])
    assert (got1.transmittance - ref1.transmittance).abs().max().item() <= 1e-5
    got2 = _march(host_lib, params, static, rays, 1, trans_total=ref1.transmittance)
    ref2 = march.camera_march_plain(params, static, *rays[:2], SEED, rays[2], ref1.transmittance)
    assert (got2.transmittance - ref2.transmittance).abs().max().item() <= 1e-5
    assert (got2.ok == ref2.ok).float().mean().item() >= 0.995
    both = got2.ok & ref2.ok
    assert int(both.sum()) > 0
    assert (got2.scatter_pos - ref2.scatter_pos)[both].abs().max().item() <= 1e-4
    assert (got2.direct - ref2.direct)[both].abs().max().item() <= 1e-3 * ref2.direct.abs().max().item()


def test_k2_column_equals_element(host_lib, neural_rig):
    """192 points from 5 % outside to 5 % beyond the box (the fade), random
    view directions: every (point, layer, column) bitwise; the plain version
    within 1e-5."""
    params, static, _ = neural_rig
    rng = np.random.default_rng(3)
    b = params.bbox_size.numpy()
    pos = torch.as_tensor((rng.uniform(-0.05, 1.05, (192, 3)) * b).astype(np.float32))
    view = rng.normal(size=(192, 3)).astype(np.float32)
    view = torch.as_tensor(view / np.linalg.norm(view, axis=-1, keepdims=True))
    host_lib.host_set_descriptor(0)
    ref = descriptor._launch(params, static, pos, view, lib=host_lib)
    host_lib.host_set_descriptor(1)
    got = descriptor._launch(params, static, pos, view, lib=host_lib)
    assert got.shape == (192, 10, 226)
    assert torch.equal(got, ref)
    assert bool((got[:, :, :225] == 0.0).any()) and bool((got[:, :, :225] > 0.0).any())
    plain = descriptor.network_inputs_plain(params, static, pos, view)
    assert (got - plain).abs().max().item() <= 1e-5


@pytest.mark.parametrize("layers", [3, 9])
def test_k2_baked_layers_column_equals_element(host_lib, neural_rig, layers):
    """3 layers along the view and 9 in the frame of the probe direction."""
    params, static, _ = neural_rig
    rng = np.random.default_rng(layers)
    b = params.bbox_size.numpy()
    pos = torch.as_tensor((rng.uniform(-0.05, 1.05, (96, 3)) * b).astype(np.float32))
    view = rng.normal(size=(96, 3)).astype(np.float32)
    view = torch.as_tensor(view / np.linalg.norm(view, axis=-1, keepdims=True))
    frame = baked.probe_frames(96, "cpu") if layers == 9 else None
    host_lib.host_set_descriptor(0)
    ref = descriptor._launch(params, static, pos, view, layers, frame, lib=host_lib)
    host_lib.host_set_descriptor(1)
    got = descriptor._launch(params, static, pos, view, layers, frame, lib=host_lib)
    assert got.shape == (96, layers, 226)
    assert torch.equal(got, ref)
    plain = descriptor.network_inputs_plain(params, static, pos, view, layers, frame)
    assert (got - plain).abs().max().item() <= 1e-5


def _plane_units(rng, n):
    """Lattice-unit points on the four test planes of random cells."""
    pts = []
    for v in tetra._TEST_VERTICES:
        ab = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
        ab = np.where(ab.sum(-1, keepdims=True) > 1.0, 1.0 - ab, ab)
        q = np.concatenate([ab, 1.0 - ab.sum(-1, keepdims=True)], axis=-1)
        pts.append(np.where(v > 0, 1.0 - q, q))
    local = np.clip(np.concatenate(pts), 0.0, 1.0 - 2**-24)
    return (local + rng.integers(0, 16, local.shape)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_k5_equals_plain(host_lib, neural_rig, dtype):
    params, static, _ = neural_rig
    rng = np.random.default_rng(17)
    shape = (18, 18, 18, baked.PROBE_LENGTH)
    if dtype == "uint8":
        probes = torch.as_tensor(rng.integers(0, 256, shape).astype(np.uint8))
    else:
        probes = torch.as_tensor(rng.random(shape).astype(np.float32))
    b = params.bbox_size.numpy()
    inside = rng.uniform(-0.05, 1.05, (400, 3)) * b
    planes = _plane_units(rng, 64) / np.float32(baked._lattice_units(static))
    pos = torch.as_tensor(np.concatenate([inside, planes]).astype(np.float32))
    view = rng.normal(size=(pos.shape[0], 3)).astype(np.float32)
    view = torch.as_tensor(view / np.linalg.norm(view, axis=-1, keepdims=True))
    got = baked._launch(params, static, probes, pos, view, lib=host_lib)
    ref = baked.interpolate_probes_plain(params, static, probes, pos, view)
    assert got.shape == (pos.shape[0], baked.PROBE_IN_WIDTH)
    assert torch.equal(got[:, : baked.PROBE_LENGTH], ref[:, : baked.PROBE_LENGTH])
    assert (got[:, baked.PROBE_LENGTH:] - ref[:, baked.PROBE_LENGTH:]).abs().max().item() <= 1e-6


def _k5_case(params, static, dtype, seed):
    rng = np.random.default_rng(seed)
    shape = (18, 18, 18, baked.PROBE_LENGTH)
    if dtype == "uint8":
        probes = torch.as_tensor(rng.integers(0, 256, shape).astype(np.uint8))
    else:
        probes = torch.as_tensor(rng.random(shape).astype(np.float32))
    b = params.bbox_size.numpy()
    inside = rng.uniform(-0.05, 1.05, (300, 3)) * b
    planes = _plane_units(rng, 32) / np.float32(baked._lattice_units(static))
    pos = torch.as_tensor(np.concatenate([inside, planes]).astype(np.float32))
    view = rng.normal(size=(pos.shape[0], 3)).astype(np.float32)
    view = torch.as_tensor(view / np.linalg.norm(view, axis=-1, keepdims=True))
    return probes, pos, view


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_k5_redesign_equals_first_design(host_lib, neural_rig, dtype):
    """Every column of every row, bitwise: the 4-channel words and the
    angles of the redesign against the first design's elements."""
    params, static, _ = neural_rig
    probes, pos, view = _k5_case(params, static, dtype, 23)
    try:
        host_lib.host_set_probes(0)
        first = baked._launch(params, static, probes, pos, view, lib=host_lib)
    finally:
        host_lib.host_set_probes(1)
    got = baked._launch(params, static, probes, pos, view, lib=host_lib)
    assert torch.equal(got, first)
    assert bool((got[:, : baked.PROBE_LENGTH] > 0).any())


SAMPLES_N = 160


def _samples(lib, params, static, mode, lanes=32, seed=SEED, n=SAMPLES_N):
    """K7a's host build: ``mode`` 0 ``sample_attempts``, 1 attempts in order
    in chunks of ``lanes`` lanes, 2 rounds of ``lanes`` attempts."""
    lib.host_set_samples(mode, lanes)
    try:
        return collectors._launch_samples(params, static, n, seed, lib=lib)
    finally:
        lib.host_set_samples(2, lib.ds_sample_warps())


@pytest.mark.parametrize("lanes", [1, 8, 32])
def test_k7a_chunks_equal_the_attempt_loop(host_lib, neural_rig, lanes):
    params, static, _ = neural_rig
    ref = _samples(host_lib, params, static, 0)
    got = _samples(host_lib, params, static, 1, lanes)
    for name, a, b in zip(ref._fields, got, ref):
        assert torch.equal(a, b), name
    assert bool(ref.found.any()) and int(ref.attempts.max()) > 1


def test_k7a_host_build_matches_plain(host_lib, neural_rig):
    """The kernel's design (rounds of ``kSampleWarps`` attempts) against the
    plain version."""
    params, static, _ = neural_rig
    got = _samples(host_lib, params, static, 2, host_lib.ds_sample_warps())
    ref = collectors.generate_scatter_samples_plain(params, static, SAMPLES_N, SEED)
    assert (got.found == ref.found).float().mean().item() >= 0.995
    same = (got.attempts == ref.attempts) & got.found & ref.found
    assert same.float().mean().item() >= 0.95
    assert (got.positions - ref.positions)[same].abs().max().item() <= 1e-4
    assert (got.directions - ref.directions)[same].abs().max().item() <= 1e-6


THIN_SAMPLES = 600


@pytest.fixture(scope="module")
def thin_rig():
    """The 24^3 cumulus at 2000 m, uint8, step 1/64, its density scaled by
    0.003: an attempt scatters with a probability of ~1 %, so samples take
    up to 256 attempts (mean ~107) and some never scatter."""
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        rendering=config.CloudRendering(march_dtype="uint8", sample_step=1.0 / 64.0))
    params, static = build_scene(cfg, procedural.cumulus(24, seed=11), device="cpu")
    return params, dataclasses.replace(static,
                                       density_multiplier=static.density_multiplier * 0.003)


@pytest.mark.parametrize("warps", [1, 3, 8, 32])
def test_k7a_rounds_equal_the_attempt_loop(host_lib, thin_rig, warps):
    params, static = thin_rig
    ref = _samples(host_lib, params, static, 0, n=THIN_SAMPLES)
    got = _samples(host_lib, params, static, 2, warps, n=THIN_SAMPLES)
    for name, a, b in zip(ref._fields, got, ref):
        assert torch.equal(a, b), name
    w = host_lib.ds_sample_warps()
    last_round = ref.found & (ref.attempts > 256 - w)
    assert int(last_round.sum()) > 0, "no sample scatters only in its last round"
    never = ~ref.found
    assert int(never.sum()) > 0 and bool((ref.attempts[never] == 256).all())
    assert bool((ref.positions[never] == 0).all()) and int(ref.steps[never].min()) > 0


def _radiance_rig(pt_rig, n=24):
    """Points on the 24^3 cumulus: the rig's box entries of the first n
    hitting pixels, in the multiple-scatter mode at max_depth 10."""
    params, static, (entry, d, hit, _) = pt_rig
    static = dataclasses.replace(collectors.radiance_static(static), max_depth=10)
    idx = torch.nonzero(hit).flatten()[:n]
    return params, static, entry[idx].contiguous(), d[idx].contiguous()


def test_k7b_bases_near_2_32_equal_scalar_launches(host_lib, pt_rig):
    """Bases 2^32 - 4 .. : the experiments of a pixel wrap past 2^32 within
    the launch, as the JAX loop's int32 sums cast to uint32 do."""
    params, static, entry, d = _radiance_rig(pt_rig, 6)
    n = entry.shape[0]
    hit = torch.ones(n, dtype=torch.bool)
    ids = torch.arange(100, 100 + n)
    base = torch.tensor([2**32 - 4, 2**32 - 1, 0, 7, 2**31 - 2, 2**32 - 2])
    host_lib.host_set_pathtrace(1, 0, None)
    got, _ = collectors.launch_radiance(params, static, entry, d, ids, base, SEED, SAMPLES,
                                        lib=host_lib)
    for r in range(n):
        one = slice(r, r + 1)
        ref = pathtracer._launch(params, static, entry[one], d[one], hit[one], ids[one], SEED,
                                 int(base[r]), SAMPLES, None, lib=host_lib)
        for name, a, b in zip(ref._fields, got, ref):
            assert torch.equal(a[one], b), (r, name)
    host_lib.host_set_pathtrace(0, 0, None)
    try:
        loop, _ = collectors.launch_radiance(params, static, entry, d, ids, base, SEED, SAMPLES,
                                             lib=host_lib)
    finally:
        host_lib.host_set_pathtrace(1, 0, None)
    _assert_equal(got, loop)
    # The seed of experiment k is subframe_seed(seed, base + k), wrapped.
    k = torch.arange(SAMPLES)
    seeds = rng_ops.subframe_seed(SEED, base[:, None] + k)
    assert int(seeds.max()) < 2**32 and bool((seeds[0, 3:] == rng_ops.subframe_seed(
        SEED, k[3:] - 4)).all())


def test_k7b_records_equal_one_experiment_launches(host_lib, pt_rig):
    """Experiment k of lane r (its record) equals a one-experiment launch of
    that lane with the base sub0[r] + k, wrapped: what the card's check of
    the collector's update relies on."""
    params, static, entry, d = _radiance_rig(pt_rig)
    n = entry.shape[0]
    ids = torch.arange(40, 40 + n)
    base = torch.tensor([2**32 - 2, 5, 2**31 - 1, 0] * (n // 4))
    host_lib.host_set_pathtrace(1, 0, None)
    pm, rec = collectors.launch_radiance(params, static, entry, d, ids, base, SEED, SAMPLES,
                                         lib=host_lib)
    assert rec.radiance.shape == (SAMPLES, n, 3) and rec.work.shape == (SAMPLES, n, 2)
    assert torch.equal(rec.work.sum(dim=0).long(), torch.stack([pm.steps, pm.bounces], dim=1))
    k = torch.arange(SAMPLES)
    sub = ((base[None, :] + k[:, None]) & 0xFFFFFFFF).reshape(-1)
    one, _ = collectors.launch_radiance(params, static, entry.repeat(SAMPLES, 1),
                                        d.repeat(SAMPLES, 1), ids.repeat(SAMPLES), sub, SEED, 1,
                                        lib=host_lib)
    assert torch.equal(one.mean, rec.radiance.reshape(-1, 3))
    assert torch.equal(torch.stack([one.steps, one.bounces], dim=1),
                       rec.work.reshape(-1, 2).long())
    assert bool((rec.work[..., 1] > 0).any()) and bool((rec.radiance > 0).any())


def test_k7b_moments_match_plain(host_lib, pt_rig):
    """The collector's update through the host build and through the plain
    version: per-point counts equal; moments within the K4 tolerances."""
    params, static, entry, d = _radiance_rig(pt_rig)
    n = entry.shape[0]
    rids = torch.arange(n)
    exp_base = torch.full((n,), 2**32 - 5, dtype=torch.int64)
    host_lib.host_set_pathtrace(1, 0, None)
    got = collectors.radiance_moments(params, static, entry, d, rids, exp_base, SEED, 3, 4,
                                      lib=host_lib)
    ref = collectors.radiance_moments_plain(params, static, entry, d, rids, exp_base, SEED, 3, 4)
    assert torch.equal(got[0], ref[0]) and float(got[0][0]) == 12.0
    assert (got[1] - ref[1]).abs().max().item() <= 1e-5 * (ref[1].abs().max().item() + 1e-12) * 12
    assert (got[2] - ref[2]).abs().max().item() <= 1e-4 * (ref[2].abs().max().item() + 1e-12) * 12


@pytest.mark.parametrize("park_at", [1, 0, 32])
def test_k7b_deferred_equals_the_item_loop(host_lib, pt_rig, park_at):
    """The kernel's deferred scatters (park_at 0: its ``kParkAt``) against K4's
    item loop, records and folds bitwise, in item order, shuffled and
    point-major; then with a cap of 27 steps a sample."""
    params, static, entry, d = _radiance_rig(pt_rig)
    n = entry.shape[0]
    ids = torch.arange(40, 40 + n)
    base = torch.tensor([2**32 - 2, 5, 2**31 - 1, 0] * (n // 4))
    sub32 = torch.where(base < 2**31, base, base - 2**32).to(torch.int32).contiguous()
    q = np.arange(n * SAMPLES)
    orders = (None, _shuffled((entry,), 5), ((q % SAMPLES) * n + q // SAMPLES).astype(np.int64))

    def radiance(mode, order, cap):
        host_lib.host_set_pathtrace(1, 0, None if order is None else order.ctypes.data)
        host_lib.host_set_radiance(mode, park_at)
        try:
            return pathtracer.launch_entry(
                host_lib, "ds_radiance", pathtracer.RADIANCE_ARGTYPES, cuda_build.ptr(sub32),
                params, static, entry, d, torch.ones(n, dtype=torch.bool), ids, SEED, SAMPLES,
                cap)
        finally:
            host_lib.host_set_pathtrace(1, 0, None)
            host_lib.host_set_radiance(1, 0)

    for cap in (None, 27):
        ref_pm, ref_rec, _ = radiance(0, None, cap)
        if cap is None:
            assert int(ref_pm.bounces.sum()) > 0
        else:
            assert int(ref_rec.work[..., 0].max()) == 27  # the cap cut samples
        for order in orders:
            pm, rec, _ = radiance(1, order, cap)
            _assert_equal(pm, ref_pm)
            _assert_equal(rec, ref_rec)


def _k10_tables(n=37, seed=3):
    g = torch.Generator().manual_seed(seed)
    u8 = lambda w: torch.randint(0, 256, (n, w), generator=g, dtype=torch.uint8)  # noqa: E731
    f = lambda *s: torch.rand(*s, generator=g)  # noqa: E731
    return dict(grids=u8(10 * 225), probes=u8(4 * 9 * 225), rt=u8(3 * 225), powers=f(n, 4),
                omega=f(n), alpha=f(n), labels=f(n))


@pytest.mark.parametrize("rows", [[5, 0, 36, 5, 17, 2, 2, 30], [11]])
def test_k10_equals_plain(host_lib, rows):
    t = _k10_tables()
    idx = torch.tensor(rows, dtype=torch.int64)
    got = device_data._launch_disney(t["grids"], t["omega"], t["labels"], idx, lib=host_lib)
    ref = device_data.assemble_disney_plain(t["grids"], t["omega"], t["labels"], idx)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    args = [t[k] for k in ("probes", "rt", "powers", "omega", "alpha", "labels")]
    got = device_data._launch_baked(*args, idx, lib=host_lib)
    ref = device_data.assemble_baked_plain(*args, idx)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_k10_rows_outside_the_table_are_nan(host_lib):
    t = _k10_tables()
    idx = torch.tensor([3, 37, -1, 4], dtype=torch.int64)
    z, lab = device_data._launch_disney(t["grids"], t["omega"], t["labels"], idx, lib=host_lib)
    bad = torch.tensor([False, True, True, False])
    assert bool(z[bad].isnan().all()) and bool(lab[bad].isnan().all())
    assert not bool(z[~bad].isnan().any())
    out = device_data._launch_baked(*(t[k] for k in ("probes", "rt", "powers", "omega", "alpha",
                                                     "labels")), idx, lib=host_lib)
    assert all(bool(o[bad].isnan().all()) and not bool(o[~bad].isnan().any()) for o in out)


# -- K8a (the bake's adjoint) and K8b (the quadrature march, the sun march) ---

#: A 12^3 random cloud (zero on a 3-voxel shell), tests/test_diff_render.py's
#: frame arguments with 128 steps of 1/64 (two box lengths: every ray that
#: hits leaves the box before its last step, where the kernels stop).
DIFF_KW = dict(width=12, height=8, density_multiplier=40.0, n_steps=128, sun_steps=48,
               sample_step=1.0 / 64.0, remat_chunk=16,
               sun_cos_half_angle=math.cos(math.radians(0.53) / 2.0))


def _diff_scene(eye=(2.5, -0.4, 0.0), res=12):
    d = np.zeros((res,) * 3, np.float32)
    d[3:-3, 3:-3, 3:-3] = np.random.default_rng(0).random((res - 6,) * 3).astype(np.float32)
    return diff.diff_scene_from_numpy(d / d.max(), np.asarray([-0.3, -0.9, 0.1], np.float32),
                                      np.asarray(eye, np.float32), np.zeros(3, np.float32),
                                      np.full(3, 1e6, np.float32), device="cpu")


@pytest.fixture(scope="module", params=["baked", "pointwise"])
def diff_rig(request):
    """(scene, render arguments, the march's inputs through the plain bake,
    a random upstream gradient a ray: 0 where the ray misses)."""
    scene = _diff_scene(eye=(3.0, -0.4, 0.2))
    kw = dict(DIFF_KW, use_baked_inscatter=request.param == "baked")
    with torch.no_grad():
        m = diff.march_setup(scene, kernels=False, **kw)
    g = torch.from_numpy(np.random.default_rng(1).random(m.hit.shape[0]).astype(np.float32))
    return scene, kw, m, torch.where(m.hit, g, 0.0).contiguous()


def _march_args(scene, m):
    return (scene.density, m.baked, None if m.to_sun is None else m.to_sun.contiguous(),
            m.entry.contiguous(), m.dirs.contiguous(), m.p_phase.contiguous(),
            m.hit.to(torch.uint8), m.meta)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_k8b_forward_equals_plain_and_stops_at_the_box_exit(host_lib, diff_rig):
    scene, kw, m, _ = diff_rig
    assert bool((~m.hit).any())  # some rays miss the box
    steps = torch.zeros((m.hit.shape[0], 3), dtype=torch.int32)
    got = diff.launch_march(*_march_args(scene, m), steps=steps, lib=host_lib)
    with torch.no_grad():
        ref = diff.quadrature_march_plain(scene.density, m.baked, m.to_sun, m.entry, m.dirs,
                                          m.p_phase, m.meta, kw["remat_chunk"])
    assert _rel(got[m.hit], ref[m.hit]) <= 1e-6
    assert bool((got[~m.hit] == 0).all())
    # Every ray that hits stops at the box exit, before the last step; the
    # in-scatter is read on the steps with sigma != 0.
    assert bool((steps[m.hit, 0] > 0).all()) and int(steps[:, 0].max()) < m.meta.n_steps
    assert bool((steps[:, 1] <= steps[:, 0]).all()) and int(steps[:, 1].sum()) > 0
    # The sun march's samples at the steps with sigma != 0: pointwise only.
    if m.baked is None:
        assert int(steps[:, 2].sum()) > 0 and bool((steps[steps[:, 1] == 0, 2] == 0).all())
    else:
        assert int(steps[:, 2].abs().sum()) == 0


def test_k8b_adjoint_equals_autograd(host_lib, diff_rig):
    scene, kw, m, g = diff_rig
    args = _march_args(scene, m)
    rad = diff.launch_march(*args, lib=host_lib)
    got = diff.launch_march_bwd(*args[:7], rad, g, m.meta, lib=host_lib)
    names = ["density", "entry", "dirs", "p_phase", "baked" if m.baked is not None else "to_sun"]
    leaves = {n: (getattr(scene, n) if n == "density" else getattr(m, n)).detach().clone()
              .requires_grad_(True) for n in names}
    ref = diff.quadrature_march_plain(
        leaves["density"], leaves.get("baked"), leaves.get("to_sun"), leaves["entry"],
        leaves["dirs"], leaves["p_phase"], m.meta, kw["remat_chunk"])
    want = dict(zip(names, torch.autograd.grad(ref, list(leaves.values()), g)))
    for name in names:
        assert _rel(getattr(got, name), want[name]) <= 1e-5, name
    # The replay's R - prefix on the deepest rays: each ray's d/d entry and
    # d/d dirs against autograd's, relative to that ray's largest.
    steps = torch.zeros((m.hit.shape[0], 3), dtype=torch.int32)
    diff.launch_march(*args, steps=steps, lib=host_lib)
    deep = torch.argsort(steps[:, 0], descending=True)[:8]
    for name in ("entry", "dirs"):
        a, b = getattr(got, name)[deep], want[name][deep]
        assert float(((a - b).abs().amax(1) / b.abs().amax(1).clamp_min(1e-30)).max()) <= 1e-4, name


def test_k8b_adjoint_of_missed_and_axis_parallel_rays_is_finite(host_lib):
    """An eye on the x axis (the centre pixel's ray has zero y and z
    components) far enough that the frame's border rays miss: every
    gradient finite, exactly 0 on the rays that miss."""
    scene = _diff_scene(eye=(3.0, 0.0, 0.0))
    for baked in (True, False):
        with torch.no_grad():
            m = diff.march_setup(scene, kernels=False,
                                 **dict(DIFF_KW, use_baked_inscatter=baked))
        assert bool(((m.dirs[:, 1] == 0) & (m.dirs[:, 2] == 0)).any())
        assert bool((~m.hit).any())
        args = _march_args(scene, m)
        rad = diff.launch_march(*args, lib=host_lib)
        got = diff.launch_march_bwd(*args[:7], rad, torch.ones_like(rad), m.meta, lib=host_lib)
        for t in got:
            assert t is None or bool(torch.isfinite(t).all())
        assert bool((got.entry[~m.hit] == 0).all()) and bool((got.p_phase[~m.hit] == 0).all())


def test_k8a_equals_autograd_of_the_plain_bake(host_lib):
    """K8a on an upstream gradient of every voxel (a quarter of them 0)
    against autograd of the plain bake: the density gradient (summed in
    float64 by both) within 1e-6 of its largest value, the light's 1e-5."""
    scene = _diff_scene()
    density = scene.density
    sun_n = scene.sun_dir / torch.linalg.norm(scene.sun_dir)
    bbox, light, dm, step = diff._bbox_host(density.shape), tuple(sun_n.tolist()), 40.0, 1 / 64
    trans = inscatter.launch_bake(density, bbox, light, step, dm, False, lib=host_lib)
    rng = np.random.default_rng(2)
    g = torch.from_numpy((rng.random(density.numel()) * (rng.random(density.numel()) > 0.25))
                         .astype(np.float32))
    got_d, got_l = diff.launch_bake_adjoint(density, bbox, light, dm, step, trans, g,
                                            lib=host_lib)
    dl = density.clone().requires_grad_(True)
    ll = sun_n.clone().requires_grad_(True)
    out = diff.bake_inscatter_diff_plain(dl, diff._bbox(density), ll, dm, step)
    assert _rel(trans.reshape(density.shape), out.detach()) <= 1e-6
    want_d, want_l = torch.autograd.grad(out, (dl, ll), g.reshape(density.shape))
    assert _rel(got_d, want_d) <= 1e-6
    assert _rel(got_l, want_l) <= 1e-5


@pytest.mark.parametrize("light", list(LIGHTS))
def test_k8a_rows_equal_the_voxel_loop(host_lib, light):
    """K8a's row form against its per-voxel first design on the 20 x 28 x 36
    grid (rows of 36, a box that is not a power of two: IEEE divisions),
    224 steps of 1/128 (past the box's diagonal: every march leaves the
    box), a quarter of the upstream 0."""
    density = torch.from_numpy(_smooth_grid())
    to_light = np.asarray(LIGHTS[light], np.float64)
    light_dir = tuple(float(v) for v in (to_light / np.linalg.norm(to_light)).astype(np.float32))
    bbox, dm, step = diff._bbox_host(density.shape), 60.0, 1.0 / 128.0
    trans = inscatter.launch_bake(density, bbox, light_dir, step, dm, False, lib=host_lib)
    rng = np.random.default_rng(6)
    g = torch.from_numpy((rng.random(density.numel()) * (rng.random(density.numel()) > 0.25))
                         .astype(np.float32))
    got = {}
    try:
        for mode in (0, 1):
            host_lib.host_set_diff(mode, 1, 0)
            got[mode] = diff.launch_bake_adjoint(density, bbox, light_dir, dm, step, trans, g,
                                                 lib=host_lib, float64=True)
    finally:
        host_lib.host_set_diff(1, 1, 0)
    (ref_d, ref_l), (row_d, row_l) = got[0], got[1]
    assert _rel(row_d, ref_d) <= 1e-12
    assert _rel(row_l, ref_l) <= 1e-6
    # Every face's texels take a gradient: the voxels on it, and on the
    # faces the marches leave across, the clamped samples of every march.
    faces = [ref_d.select(a, e) for a in range(3) for e in (0, density.shape[a] - 1)]
    assert all(bool((f != 0).any()) for f in faces)


#: The card tests' differentiable frame (test_torch_cuda_kernels.py): the
#: 24^3 cumulus of seed 29, 32 x 16, 224 steps of 1/128.
CARD_DIFF_KW = dict(width=32, height=16, density_multiplier=100.0, n_steps=224, sun_steps=64,
                    sample_step=1.0 / 128.0, remat_chunk=32,
                    sun_cos_half_angle=math.cos(math.radians(0.53) / 2.0))


@pytest.fixture(scope="module", params=["baked", "pointwise"])
def lanes_rig(request):
    """The card tests' 24^3 scene, its march inputs (through the plain
    bake), a random upstream a ray (0 where the ray misses)."""
    from deepestscatter_tpu_torch.ops import grid as grid_ops

    density = grid_ops.normalize_density(procedural.cumulus(resolution=24, seed=29))
    scene = diff.diff_scene_from_numpy(
        density, np.asarray([-0.3, -0.9, 0.1], np.float32),
        np.asarray([2.5, -0.4, 0.0], np.float32), np.zeros(3, np.float32),
        np.full(3, 1e6, np.float32), device="cpu")
    kw = dict(CARD_DIFF_KW, use_baked_inscatter=request.param == "baked")
    with torch.no_grad():
        m = diff.march_setup(scene, kernels=False, **kw)
    g = torch.from_numpy(np.random.default_rng(9).random(m.hit.shape[0]).astype(np.float32))
    g = torch.where(m.hit, g, 0.0).contiguous()
    return scene, m, g, _march_args(scene, m)


def _march_bwd(host_lib, args, g, m, mode, lanes):
    host_lib.host_set_diff(1, mode, lanes)
    try:
        rad = diff.launch_march(*args, lib=host_lib)
        return diff.launch_march_bwd(*args[:7], rad, g, m.meta, lib=host_lib)
    finally:
        host_lib.host_set_diff(1, 1, 0)


@pytest.mark.parametrize("lanes", [1, 8, 32])
def test_k8b_lanes_equal_the_ray_loop(host_lib, lanes_rig, lanes):
    """K8b's adjoint in chunks of G lanes a ray against its per-ray first
    replay: bitwise at G = 1 (the chunk logic alone), within 1e-5 of each
    leaf's largest at G = 8 and 32 (the lanes' sums of d/d entry, dirs and
    to_sun, and the runs' sums of the grid scatters, in another float32
    order)."""
    scene, m, g, args = lanes_rig
    ref = _march_bwd(host_lib, args, g, m, 0, 0)
    got = _march_bwd(host_lib, args, g, m, 1, lanes)
    for name in got._fields:
        a, b = getattr(got, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        assert float(b.abs().max()) > 0, name
        if lanes == 1:
            assert torch.equal(a, b), name
        else:
            assert _rel(a, b) <= 1e-5, name


def _forward_mode(host_lib, march=1, lanes=0, sun=2, sun_lanes=0):
    """A context setting the host build's K8b forward and sun march
    (host_set_diff_forward), the kernels' again on leaving."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        host_lib.host_set_diff_forward(march, lanes, sun, sun_lanes)
        try:
            yield
        finally:
            host_lib.host_set_diff_forward(1, 0, 2, 0)

    return ctx()


def _first_in_box(e, d, meta):
    """Each ray's first step in the box (-1: none), as the kernels sample."""
    s = torch.tensor([diff._step_distance(meta.step, i + 1) for i in range(meta.n_steps)])
    u = (e[:, None, :] + d[:, None, :] * s[:, None]) / torch.tensor(meta.bbox)
    inside = ((u >= 0) & (u <= 1)).all(dim=-1)
    return torch.where(inside.any(dim=1), inside.to(torch.int64).argmax(dim=1), -1)


@pytest.mark.parametrize("back", [0, 7, 31])
@pytest.mark.parametrize("lanes", [1, 8, 32])
def test_k8b_forward_lanes_equal_the_ray_loop(host_lib, lanes_rig, lanes, back):
    """K8b's forward in chunks of G lanes a ray (march_lanes_kernel's
    lane_span, lane_sum; pointwise with each lit lane's own sun
    march) equals its per-ray first design march_ray
    bitwise: the radiance and the three step counts.  The entries moved
    back along the ray by ``back`` and a half steps put each ray's first
    step in the box on lane 7 (a chunk's last at G = 8) or 31 (its last at
    32); the march capped at 45 steps ends inside a chunk."""
    scene, m, g, args = lanes_rig
    e = (args[3] - args[4] * ((back + 0.5) * m.meta.step)).contiguous() if back else args[3]
    first = _first_in_box(e, args[4], m.meta)
    assert float((first[m.hit] == back).to(torch.float64).mean()) > 0.5
    n = m.hit.shape[0]
    for meta in (m.meta, m.meta._replace(n_steps=45)):
        a = (*args[:3], e, *args[4:7], meta)
        ref_steps = torch.zeros((n, 3), dtype=torch.int32)
        with _forward_mode(host_lib, march=0):
            ref = diff.launch_march(*a, steps=ref_steps, lib=host_lib)
        if meta.n_steps == 45:  # the cap ends rays still in the box
            assert bool((ref_steps[:, 0] == 45 - back).any())
        else:
            assert float(ref.abs().max()) > 0 and int(ref_steps[:, 1].sum()) > 0
        steps = torch.zeros((n, 3), dtype=torch.int32)
        with _forward_mode(host_lib, march=1, lanes=lanes):
            got = diff.launch_march(*a, steps=steps, lib=host_lib)
        assert torch.equal(got, ref), meta.n_steps
        assert torch.equal(steps, ref_steps), meta.n_steps


@pytest.mark.parametrize("n_steps", [45, 128])
@pytest.mark.parametrize("mode, lanes", [(2, 0), (1, 1), (1, 8), (1, 32)],
                         ids=["thread-a-point", "lanes-1", "lanes-8", "lanes-32"])
def test_sun_march_lanes_equal_the_point_loop(host_lib, mode, lanes, n_steps):
    """The kernels' sun march, a thread a point (strided samples; the
    adjoint's runs of steps in one cell merged), equals its first design
    sun_march bitwise in T and the samples in the box, on points in and
    around the box (some enter it after their first steps), with 45 steps
    (a cap inside a chunk of 8 or 32) and with the main path's 128; its
    adjoint within 1e-5 of each output's largest.  The lane form of
    csrc/diff_variants.cu in chunks of G lanes a point (sun_march_lanes)
    likewise, its adjoint (sun_march_adjoint_lanes: runs of lanes in one
    cell summed before their adds, d/dq and d/d to_sun summed over the
    lanes) bitwise at G = 1."""
    scene = _diff_scene()
    pos = torch.from_numpy(np.random.default_rng(12).uniform(-0.25, 1.25, (400, 3))
                           .astype(np.float32))
    to_sun = diff._to_sun(scene.sun_dir).contiguous()
    w = torch.from_numpy(np.random.default_rng(13).random(400).astype(np.float32))
    out = {}
    for sun in (0, mode):  # the first design, then the design under test
        steps = torch.zeros(400, dtype=torch.int32)
        with _forward_mode(host_lib, sun=sun, sun_lanes=lanes):
            t = diff.launch_sun_march(scene.density, to_sun, pos, 40.0, n_steps, 1 / 64,
                                      steps=steps, lib=host_lib)
            back = diff.launch_sun_march_bwd(scene.density, to_sun, pos, t, w, 40.0, n_steps,
                                             1 / 64, lib=host_lib)
        out[sun] = (t, steps, back)
    (t0, s0, b0), (t1, s1, b1) = out[0], out[mode]
    assert torch.equal(t1, t0) and torch.equal(s1, s0)
    assert bool((t0 < 0.9).any()) and bool((s0 == 0).any())
    # 45 steps: the cap ends marches still in the box; 128: the box's exit.
    assert bool((s0 == 45).any()) if n_steps == 45 else int(s0.max()) in range(46, n_steps)
    inside = ((pos >= 0) & (pos <= 1)).all(dim=1)
    assert bool((~inside & (s0 > 0)).any())  # points that enter the box on the way
    for a, b in zip(b1, b0):
        assert float(b.abs().max()) > 0
        if mode == 1 and lanes == 1:
            assert torch.equal(a, b)
        else:
            assert _rel(a, b) <= 1e-5


def test_k8a_on_a_block_equals_the_plain_bake_of_the_block(host_lib):
    """The upstream gradient restricted to a slab of voxels (its x and y
    faces included) through K8a against autograd of the plain bake of those
    voxels alone (chip_smoke.py's check at its frame point)."""
    scene = _diff_scene()
    density = scene.density
    sun_n = scene.sun_dir / torch.linalg.norm(scene.sun_dir)
    bbox, light, dm, step = diff._bbox_host(density.shape), tuple(sun_n.tolist()), 40.0, 1 / 64
    trans = inscatter.launch_bake(density, bbox, light, step, dm, False, lib=host_lib)
    block = torch.arange(5 * 144, 7 * 144)  # z = 5, 6
    g = torch.zeros(density.numel())
    g[block] = torch.from_numpy(np.random.default_rng(5).random(block.numel()).astype(np.float32))
    got_d, got_l = diff.launch_bake_adjoint(density, bbox, light, dm, step, trans, g,
                                            lib=host_lib)
    dl = density.clone().requires_grad_(True)
    ll = sun_n.clone().requires_grad_(True)
    out = diff.bake_inscatter_diff_plain(dl, diff._bbox(density), ll, dm, step, voxels=block)
    assert _rel(trans[block], out.detach()) <= 1e-6
    want_d, want_l = torch.autograd.grad(out, (dl, ll), g[block])
    assert _rel(got_d, want_d) <= 1e-6 and bool((want_d[:, :, 0] != 0).any())
    assert _rel(got_l, want_l) <= 1e-5


def test_sun_march_equals_plain(host_lib):
    scene = _diff_scene()
    pos = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (200, 3)).astype(np.float32))
    to_sun = diff._to_sun(scene.sun_dir).contiguous()
    steps = torch.zeros(200, dtype=torch.int32)
    got = diff.launch_sun_march(scene.density, to_sun, pos, 40.0, 48, 1 / 64, steps=steps,
                                lib=host_lib)
    leaves = [t.clone().requires_grad_(True) for t in (scene.density, scene.sun_dir, pos)]
    ref = diff.sun_transmittance_plain(*leaves, 40.0, 48, 1 / 64)
    assert float((got - ref.detach()).abs().max()) <= 1e-6 and bool((got < 0.9).any())
    # The samples in the box (a line crosses it once): the march's work.
    s = torch.tensor([diff._step_distance(1 / 64, j + 1) for j in range(48)])
    u = (pos[:, None, :] + to_sun * s[:, None]) / diff._bbox(scene.density)
    inside = ((u >= 0) & (u <= 1)).all(dim=-1).sum(dim=1)
    assert torch.equal(steps, inside.to(torch.int32)) and int(steps.min()) < 48
    w = torch.from_numpy(np.random.default_rng(4).random(200).astype(np.float32))
    d_dens, d_pos, d_ts = diff.launch_sun_march_bwd(scene.density, to_sun, pos, got, w, 40.0, 48,
                                                    1 / 64, lib=host_lib)
    want = torch.autograd.grad((ref * w).sum(), leaves)
    assert _rel(d_dens, want[0]) <= 1e-5 and _rel(d_pos, want[2]) <= 1e-5
    # d/d sun_dir through the normalisation, as the wrapper's autograd does.
    sd = scene.sun_dir.clone().requires_grad_(True)
    (d_sun,) = torch.autograd.grad(diff._to_sun(sd), sd, d_ts)
    assert _rel(d_sun, want[1]) <= 1e-4


@pytest.mark.parametrize("baked", [True, False], ids=["baked", "pointwise"])
def test_render_and_grads_through_the_kernels(host_lib, monkeypatch, baked):
    """The autograd Functions over the host build (K3, K8a, K8b) against
    the plain render's image and gradients of every leaf."""
    monkeypatch.setattr(cuda_build, "load", lambda name: host_lib)
    scene = _diff_scene()
    kw = dict(DIFF_KW, use_baked_inscatter=baked)
    leaves = [t.clone().requires_grad_(True) for t in scene]
    img = diff._render(diff.DiffScene(*leaves), kernels=True, **kw)
    grads = torch.autograd.grad(img.mean(), leaves)
    ref_img, ref = diff.render_and_grads(scene, device="cpu", **kw)
    assert _rel(img.detach(), ref_img) <= 1e-6
    for name, a, b in zip(diff.DiffScene._fields, grads, ref):
        assert _rel(a, b) <= (1e-5 if name == "density" else 1e-4), name


# -- K8c: the path adjoint --------------------------------------------------------

#: tests/test_diff_cross_validation.py's gradient point (its 16^3 thin cloud
#: at 400 m, sun (-0.3, -0.9, 0.1), eye (2.5, -0.4, 0), 12 x 8, max_depth 3,
#: 2 subframes, seed 4) in the four mode cases K8c takes.
MS_CASES = {
    "all_scatter": {},
    "multiple": dict(mode=config.RenderMode.SUN_MULTIPLE_SCATTER),
    "single": dict(mode=config.RenderMode.SUN_SINGLE_SCATTER),
    "sky_roulette": dict(sample_sky=True, rr_start_depth=2, rr_survival=0.8),
}
MS_KW = dict(width=12, height=8, max_depth=3, n_subframes=2, seed=4)


def _ms_scene():
    d = np.zeros((16, 16, 16), np.float32)
    d[3:-3, 3:-3, 3:-3] = np.random.default_rng(0).random((10,) * 3).astype(np.float32)
    return diff.diff_scene_from_numpy(d / d.max(), np.asarray([-0.3, -0.9, 0.1], np.float32),
                                      np.asarray([2.5, -0.4, 0.0], np.float32),
                                      np.zeros(3, np.float32), np.full(3, 1e6, np.float32),
                                      device="cpu")


def _ms_cfg(case):
    return config.SceneConfig(
        cloud=config.CloudModel(size_m=400.0),
        light=config.DirectionalLight(direction=(-0.3, -0.9, 0.1)),
        rendering=config.CloudRendering(sample_step=1.0 / 64.0, **MS_CASES[case]))


@pytest.fixture(scope="module", params=list(MS_CASES))
def ms_rig(request):
    """(case, cfg, the paths' scene with its leaves requiring grad, their
    rays, a random upstream of every record: 0 where a pixel misses)."""
    cfg = _ms_cfg(request.param)
    leaves = [t.clone().requires_grad_(True) for t in _ms_scene()]
    params, static = diff.diff_scene(cfg, diff.DiffScene(*leaves), MS_KW["max_depth"],
                                     kernels=False)
    rays = diff.path_rays(diff.DiffScene(*leaves), cfg, MS_KW["width"], MS_KW["height"], params,
                          static)
    n = rays.hit.shape[0]
    g = torch.from_numpy(np.random.default_rng(5).random((2, n, 3)).astype(np.float32))
    return request.param, cfg, params, static, rays, torch.where(rays.hit[None, :, None], g, 0.0)


def _ms_inputs(params, rays):
    """The paths' differentiable inputs, detached: density, in-scatter,
    light_dir, light_radiance, entry, dirs."""
    return [t.detach().clone() for t in (params.density_mips[0], params.inscatter,
                                         params.light_dir, params.light_radiance, rays.entry,
                                         rays.dirs)]


def _ms_plain_grads(params, static, rays, inputs, g):
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    p = params._replace(density_mips=(leaves[0],), inscatter=leaves[1], light_dir=leaves[2],
                        light_radiance=leaves[3])
    rec = diff.path_records_plain(p, static, leaves[4], leaves[5], rays.hit, rays.ids,
                                  MS_KW["seed"], MS_KW["n_subframes"])
    return rec.detach(), torch.autograd.grad(rec, leaves, g)


@pytest.fixture(scope="module")
def ms_plain(ms_rig):
    """Autograd of the plain paths at the rig's upstream: (records,
    gradients of the six inputs)."""
    _, _, params, static, rays, g = ms_rig
    return _ms_plain_grads(params, static, rays, _ms_inputs(params, rays), g)


def _ms_k8c(host_lib, params, static, rays, inputs, g, design=(-1, 0, None, -1), **kw):
    """K8c's host build in ``design`` (``host_set_path``'s arguments: the
    first design, or the kernels' with G lanes, an item order and the work
    list's front threshold)."""
    host_lib.host_set_path(*design)
    p = diff._sample_params(inputs[0], inputs[1], params.phase)
    return diff.launch_path_adjoint(p, static, inputs[4], inputs[5], rays.hit, rays.ids,
                                    MS_KW["seed"], 1, MS_KW["n_subframes"], g, lib=host_lib, **kw)


#: K8c's designs in the host build (``host_set_path``'s design, lanes, a
#: shuffled item order, the work list's front threshold): its first design
#: (a thread an item); the kernels' replay and sweep at G = 1, 8 (the
#: kernel's) and 32 lanes a sample, in item order and with the replay's
#: items in a shuffled order; and with every sample at the work list's
#: front.
K8C_DESIGNS = {"first design": (0, 0, False, -1),
               **{f"chunks G={g}": (1, g, False, -1) for g in (1, 8, 32)},
               "shuffled": (-1, 0, True, -1),
               **{f"shuffled G={g}": (1, g, True, -1) for g in (1, 32)},
               "one list": (-1, 0, False, 0)}


@pytest.mark.parametrize("design", list(K8C_DESIGNS))
def test_k8c_equals_autograd_of_the_plain_paths(host_lib, ms_rig, ms_plain, design):
    """K8c's host build in each design against autograd of the plain paths
    for a random upstream: the density within 1e-5 of its largest value,
    the in-scatter, light_dir, light_radiance, entries and directions within
    1e-4; each reference nonzero; the re-marched steps at most the sample's
    steps.  Its replay equals K4's records bitwise; on the 16 paths with
    the most steps d/d entry and d/d dirs within 1e-4 of each path's
    largest."""
    _, _, params, static, rays, g = ms_rig
    kind, lanes, shuffled, long_steps = K8C_DESIGNS[design]
    order = (np.random.default_rng(3).permutation(g.shape[0] * g.shape[1]).astype(np.int64)
             if shuffled else None)
    inputs = _ms_inputs(params, rays)
    remarch = torch.full(g.shape[:2], -1, dtype=torch.int32)
    got = _ms_k8c(host_lib, params, static, rays, inputs, g, remarch=remarch,
                  design=(kind, lanes, None if order is None else order.ctypes.data, long_steps))
    host_lib.host_set_path(-1, 0, None, -1)
    rec_ref, want = ms_plain
    # The re-marched steps: the flights that ended in an in-box scatter.
    assert bool((remarch >= 0).all()) and bool((remarch <= got.records.work[..., 0]).all())
    assert int(remarch.sum()) > 0
    names = ("density", "inscatter", "light_dir", "light_radiance", "entry", "dirs")
    for name, w in zip(names, want):
        a = getattr(got, name)
        assert bool(torch.isfinite(a).all()), name
        assert float(w.abs().max()) > 0, name
        assert _rel(a, w) <= (1e-5 if name == "density" else 1e-4), name
    host_lib.host_set_pathtrace(1, 0, None)  # K4's items, at its lookahead
    k4 = pathtracer.launch_samples(diff._sample_params(inputs[0], inputs[1], params.phase),
                                   static, inputs[4], inputs[5], rays.hit, rays.ids,
                                   MS_KW["seed"], 1, MS_KW["n_subframes"], lib=host_lib)
    hit = rays.hit
    assert torch.equal(got.records.radiance[:, hit], k4.radiance[:, hit])
    assert torch.equal(got.records.work[:, hit], k4.work[:, hit])
    assert _rel(got.records.radiance, rec_ref) <= 1e-6
    steps = got.records.work[..., 0].sum(dim=0)
    deep = torch.argsort(steps, descending=True)[:16]
    for name, a, w in (("entry", got.entry, want[4]), ("dirs", got.dirs, want[5])):
        per = (a[deep] - w[deep]).abs().amax(1) / w[deep].abs().amax(1).clamp_min(1e-30)
        assert float(per.max()) <= 1e-4, name


@pytest.mark.parametrize("long_steps", [8, 0, 1 << 30])
def test_k8c_work_list_holds_the_samples_with_an_upstream(host_lib, ms_rig, long_steps):
    """The replay's work list holds each sample with a nonzero upstream and
    a recorded flight (a box hit and steps marched) exactly once, for an
    upstream zero on a third of the samples and on single channels of
    others, with its flights: its in-box scatters, or one more (the last
    flight's cut, exit or escape).  The samples off the list re-march
    nothing.  With the samples that re-march 8 steps or more at its front,
    the front and the back are both filled; with 0 every sample is at the
    front, with 2^30 none."""
    _, _, params, static, rays, g = ms_rig
    rng = np.random.default_rng(8)
    g = g * torch.from_numpy(rng.random(g.shape[:2]) >= 1 / 3)[..., None]
    g[torch.from_numpy(rng.random(g.shape[:2]) < 0.2)] *= torch.tensor([0.0, 1.0, 0.0])
    inputs = _ms_inputs(params, rays)
    remarch = torch.full(g.shape[:2], -1, dtype=torch.int32)
    counters = torch.zeros(4, dtype=torch.int64)
    got = _ms_k8c(host_lib, params, static, rays, inputs, g, remarch=remarch,
                  counters=counters, design=(-1, 0, None, long_steps))
    n_sub, n = g.shape[:2]
    entries = np.zeros(n_sub * n, np.int64)
    length = host_lib.host_path_list(entries.ctypes.data, entries.shape[0])
    front = int(counters[1])
    assert length == front + int(counters[3])
    assert {8: 0 < front < length, 0: front == length, 1 << 30: front == 0}[long_steps]
    entries = torch.from_numpy(entries[:length])
    i, flights = entries >> 32, entries & 0xFFFFFFFF
    assert torch.unique(i).shape[0] == length
    # Launch item i is sample i // n of pixel i % n (one launch: r0 = 0, m = n).
    listed = torch.zeros(n_sub * n, dtype=torch.bool)
    listed[i] = True
    listed = listed.view(n_sub, n)
    want = (g != 0).any(dim=2) & rays.hit[None, :] & (got.records.work[..., 0] > 0)
    assert torch.equal(listed, want) and 0 < length < int(rays.hit.sum()) * n_sub
    bounces = got.records.work[..., 1].reshape(-1)[i].to(torch.int64)
    assert bool((flights >= bounces).all()) and bool((flights <= bounces + 1).all())
    assert int(remarch[listed].sum()) > 0 and not bool(remarch[~listed].any())
    host_lib.host_set_path(-1, 0, None, -1)


def test_k8c_launches_split_under_a_scratch_budget(host_lib, ms_rig):
    """Launches of a few pixels each (a scratch budget of 7 pixels) give
    the single launch's per-sample outputs bitwise and its sums within
    float64 rounding."""
    _, _, params, static, rays, g = ms_rig
    inputs = _ms_inputs(params, rays)
    whole = _ms_k8c(host_lib, params, static, rays, inputs, g)
    before = diff.launch_path_adjoint.launches
    per_pixel = host_lib.ds_path_pixel_bytes(MS_KW["n_subframes"], static.max_depth + 1)
    split = _ms_k8c(host_lib, params, static, rays, inputs, g, scratch_bytes=7 * per_pixel)
    assert diff.launch_path_adjoint.launches - before == -(-rays.hit.shape[0] // 7)
    for a, b in ((split.entry, whole.entry), (split.dirs, whole.dirs),
                 (split.records.radiance, whole.records.radiance),
                 (split.records.work, whole.records.work)):
        assert torch.equal(a, b)
    for name in ("density", "inscatter", "light_dir", "light_radiance"):
        assert _rel(getattr(split, name), getattr(whole, name)) <= 1e-12, name


def test_multi_scatter_render_through_the_kernels(host_lib, monkeypatch, ms_rig):
    """The render's autograd Functions over the host build (K3, K4, K8c,
    K8a) against the plain render: the image within 1e-6, the density's
    gradient within 1e-5 and every other leaf's within 1e-4 of its largest
    value."""
    _, cfg, *_ = ms_rig
    monkeypatch.setattr(cuda_build, "load", lambda name: host_lib)
    host_lib.host_set_pathtrace(1, 0, None)
    scene = _ms_scene()
    leaves = [t.clone().requires_grad_(True) for t in scene]
    img = diff._render_ms(diff.DiffScene(*leaves), cfg, kernels=True, **MS_KW)
    grads = torch.autograd.grad(img.mean(), leaves)
    ref_img, ref = diff._image_and_grads(
        lambda s: diff.render_multi_scatter_mc_plain(s, cfg, **MS_KW), scene,
        torch.device("cpu"))
    assert _rel(img.detach(), ref_img) <= 1e-6
    for name, a, b in zip(diff.DiffScene._fields, grads, ref):
        assert bool(torch.isfinite(a).all()), name
        assert _rel(a, b) <= (1e-5 if name == "density" else 1e-4), name


# -- K9 (the slab march) and K3's plane range ---------------------------------


def test_k3_planes_equal_the_whole_bake(host_lib, bake_density):
    """``ds_bake_planes`` over a split of the planes (uneven, a single
    plane) equals ``ds_bake`` over the grid, in both host forms; the plain
    version's planes equal its whole bake's."""
    dtype, density = bake_density
    cfg = config.SceneConfig(cloud=config.CloudModel(size_m=2000.0),
                             rendering=config.CloudRendering(march_dtype=dtype,
                                                             sample_step=1.0 / 128.0))
    params, static = build_scene(cfg, density, device="cpu")
    k3 = (params.density_mips[0], static.bbox, static.light_direction, static.sample_step,
          static.density_multiplier, True)
    split = ((0, 7), (7, 8), (8, 20))
    for mode in (0, 1):
        host_lib.host_set_bake(mode)
        whole = inscatter.launch_bake(*k3, lib=host_lib)
        parts = torch.cat([inscatter.launch_bake(*k3, lib=host_lib, planes=p) for p in split])
        assert torch.equal(parts, whole)
    host_lib.host_set_bake(1)
    plain = inscatter.sun_transmittance_plain(params, static)
    assert torch.equal(torch.cat([inscatter.sun_transmittance_plain(params, static, planes=p)
                                  for p in split]), plain)


def _k9_subframe(lib, params, static, rays, n_slabs, plain=False):
    """One subframe through K9 on ``n_slabs`` slabs in this process (a
    launch a slab a phase, ``spatial_render.merge_slabs``) → (radiance,
    phases, the largest difference of the plain version's records relative
    to each column's largest value (at least 1), decisions equal)."""
    from deepestscatter_tpu_torch.parallel import spatial_render as sr

    entry, d, hit, ids = rays
    st = sr.phase_static(static)
    scenes = [sr.slab_scene(params, i, n_slabs, device="cpu") for i in range(n_slabs)]
    spp = sr.default_steps_per_phase(static, static.grid_shape[0] // n_slabs)
    seed = rng_ops.subframe_seed(SEED, 1)
    check = dict(diff=0.0, same=True)

    def phase(rec, n_alive):
        outs = [sr._launch(s, st, seed, ids, spp, rec, lib=lib) for s in scenes]
        assert bool((sum(k[:, sr.TOUCHED] for k in outs) <= 1).all())  # one owner a ray
        for s, k in zip(scenes, outs if plain else ()):
            p = sr.spatial_phase_plain(s, st, seed, ids, spp, rec)
            check["same"] = check["same"] and torch.equal(p[:, sr.DEPTH:], k[:, sr.DEPTH:])
            scale = k.abs().amax(dim=0).clamp(min=1.0)
            check["diff"] = max(check["diff"], ((p - k).abs() / scale).max().item())
        return sr.merge_slabs(outs)

    rec, phases, _ = sr.run_phases(sr.begin_records(entry, d, hit, params.bbox_size), phase,
                                   spp, static.max_total_steps)
    return (torch.where(hit[:, None], rec[:, sr.RAD:sr.RAD + 3], 0.0), phases, check["diff"],
            check["same"])


@pytest.mark.parametrize("n_slabs", [1, 2, 4])
@pytest.mark.parametrize("mode", list(config.RenderMode))
def test_k9_slabs_equal_the_pixel_loop(host_lib, pt_rig, mode, n_slabs):
    """K9's device code on 1, 2 and 4 slabs equals K4's per-pixel loop
    ``pathtrace_pixel`` (one sample, the subframe's seed) bitwise; on 2
    slabs each phase's records equal the plain version's in depth, alive,
    touched and steps on every ray, and elsewhere within 1e-5 of each
    column's largest value (at least 1): glibc's ``expf``/``logf``/
    ``sinf``/``cosf`` are not torch's."""
    params, static, rays = pt_rig
    static = dataclasses.replace(static, mode=mode)
    entry, d, hit, ids = rays
    host_lib.host_set_pathtrace(0, 0, None)
    ref = pathtracer._launch(params, static, entry, d, hit, ids,
                             rng_ops.subframe_seed(SEED, 1), 0, 1, None, lib=host_lib)
    got, phases, diff, same = _k9_subframe(host_lib, params, static, rays, n_slabs,
                                           plain=n_slabs == 2)
    assert bool(ref.steps.max() < static.max_total_steps) and phases >= n_slabs
    assert torch.equal(got, torch.where(hit[:, None], ref.mean, 0.0))
    assert float(got.max()) > 0.0
    if n_slabs == 2:
        assert same and diff <= 1e-5
