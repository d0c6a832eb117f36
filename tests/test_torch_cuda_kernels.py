"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card with ``nvcc`` (they build the kernels);
on a host without one they skip.  Run them on the card with
``python -m pytest tests/test_torch_cuda_kernels.py -q``.

Tolerances: the bake within 1e-5 (T in [0, 1]) and its uint8 texture equal
on all but 0.1 % of voxels; the march's T bitwise equal in both passes,
ok flags equal on >= 99.5 % of rays, positions within 1e-4 where they
agree (the scatter point's back-correction and the NEE run through torch's
log and products in the plain version, so these keep their tolerance;
chip_smoke.py reports their bitwise share); the descriptor bitwise equal;
the path tracer's bounce loop (K4) with the same per-pixel
step counts on >= 99 % of pixels, and on those the mean within 1e-5 and
m2 within 1e-4 of their largest values (both kernels and plain versions
are compiled without FMA contraction, so bitwise is the goal); the gather
probe's sums exactly equal.  The tests of the redesigned K4 (item queue,
lookahead march, per-sample records) hold step and scatter counts equal on
every pixel.  The probe interpolation (K5) and K2 at the baked renderer's
3 and 9 layers equal their plain versions bitwise; P1's designs
(``gather.variants``) sum exactly.  K5's redesign equals its first design
(``ds_probes_first``) bitwise.  The first-scatter sampler (K7a, rounds of
``kSampleWarps`` attempts a sample) equals its plain version bitwise
(found flags, positions, directions, attempts, steps), also on a thin
cloud where samples take up to 256 attempts, some scattering only in their
last round and some never; it equals its first design (a warp a sample,
``csrc/march_variants.cu``) bitwise.  The radiance experiments (K7b,
deferred scatters) have equal counts, steps and scatters on every lane,
each experiment's record equals a one-experiment plain run, and their
moments lie within K4's tolerances; records and folds equal its first
design's (K4's item queue, ``csrc/march_variants.cu``) bitwise at other
numbers of parked lanes and another lookahead.

The batch assembly (K10) equals its plain version bitwise in both layouts
at the reference batch of 1,024 (dividing by 256 is exact), on the card
and against the CPU; an index outside the table gives a row of NaN.  The
trainer's optimizer rule on the card, given the CPU's gradients, is within
a relative 1e-6 of the CPU's; a training step's loss on the card within a
relative 1e-4 of the CPU's (cuBLAS and the CPU sum in other orders).

The differentiable renderer (``render.diff``) on a 24^3 cumulus, both
in-scatter modes: image and gradients through the kernels (K3's forward,
K8a, K8b) against the plain versions on the card and on the CPU, the image
within 1e-5 of its largest value, the density gradient within 1e-4 of its
largest, the other leaves within 1e-3; the bake's forward bitwise equal to
the plain bake; the sun march within 1e-6 (T) and 1e-4 (gradients); two
runs' images bitwise equal, their gradients within 1e-5 (atomics).  On the
render's own inputs, K8b's forward (G lanes a ray) bitwise equal to the
plain march and to its first design (a thread a ray), K8b's adjoint (G
lanes a ray) within 1e-5 of each leaf's largest of autograd of the plain
march and of its first design (a thread a ray), K8a (rows) within 1e-6 of
autograd of the plain bake and within 1e-12 of its first design (a thread
a voxel: both sum the same float32 terms in float64); the sun march (a
thread a point, strided samples) bitwise equal to its first design, its
adjoint (runs of steps in one cell merged) within 1e-5 (the first designs
build from
``csrc/diff_variants.cu``).

The differentiable multi-scatter renderer (``render_multi_scatter_mc``)
at ``test_diff_cross_validation.py``'s gradient point in all-scatter,
multiple-scatter and single-scatter mode and all-scatter with
``sample_sky`` and roulette: the image through the kernels (K3, K4, K8c,
K8a) within 1e-5 of the plain render's on the card, the density gradient
within 1e-5, the other leaves within 1e-4; K8c on the render's paths
within 1e-5 (density) and 1e-4 of autograd of the plain paths, its replay
bitwise equal to K4's records, its work list every hit sample that
marched; K8c's two kernels (the replay on K4's queue, the sweep with G
lanes a sample) against its first design (``csrc/path_adjoint_variants.cu``)
at that point and at chip_smoke.py's multi-scatter frame point, the
records bitwise and the gradients within those tolerances; the card
against the CPU at the single-scatter tolerances, K8c's gradients too;
one launch of each kernel a call, K8c's replay taking every item and its
sweep every work-list entry.

The slab march (K9, ``parallel.spatial_render.spatial_phase``) on 2
slabs of the 48^3 scene at ``max_depth`` 40 in the three modes: every
phase's records equal its plain version's on the same inputs in depth,
alive, touched and steps, the rest within 1e-5 of each column's largest
value (at least 1); the subframe bitwise equal to K4's samples.  Every
design of ``csrc/spatial_variants.cu`` (the first, a thread a ray; G
lanes a ray; other launch bounds) bitwise the package's at every phase
and K4's over the subframe.  On 4 slabs against the plain version on the
CPU: >= 99 % of pixels within 1e-5 of the image's largest value (K4's
card-against-CPU rule).  K3 over a
split of the planes (``planes=``) bitwise equal to the whole bake.

Empty-space skipping on a 48^3 grid of two cumulus blobs in opposite
corners (step 1/128; a long step is 21 lattice steps): K4 with the cell
jump and with the block skip, K7b with the cell jump, K7a with each, K1
with the block skip, each against its skipping plain version at the
tolerances above (K7a bitwise; K4 and K7b also their lattice steps jumped)
and on the card against the CPU; the cap counted in lattice steps; a block
skip without the scene's occupancy raises.  The cell jump's designs of
``csrc/pathtrace_variants.cu`` (the first, where a jump ends its chunk;
the jump inside the chunk with divided exits; the first counting its
jumps; the face table on every grid) equal the package's K4 and K7b
bitwise (records, folds, jumps), also under a cap of 30 lattice steps;
the probe of the first design's exits marches as the kernel without a
skip; at a step of 1/512 on 48^3 (face table) and 64^3 (faces by product)
the package equals the first design bitwise and the plain twin at K4's
tolerances.

The render task (``tasks.render_cloud``, NN and BNN, from ``.pt``
exports) on the card against the CPU: frames within rtol 1e-3 on >= 99.5 %
of pixels.

Card against CPU: each kernel (K1-K5, K7a, K7b) runs on the card and its
plain version on the CPU, on the same inputs (the card's scene copied
with ``scene.params_to``), at the CPU parity tests' tolerances
(``test_torch_slice_parity.py``, ``test_torch_baked_parity.py``,
``test_torch_pt_parity.py``, ``test_torch_collect_parity.py``): the two
devices' ``expf``/``logf``/``sinf``/``cosf``/``acosf`` differ in the last
bit, so these are tolerances, not bitwise gates.  K1: T within 1e-5 (T in
[0, 1]), ok flags on >= 99.5 % of rays, positions within 1e-4 on >= 99.5 %
of the rays where both scatter (a last-bit difference of ``expf`` moves a
crossing by a step, 1/512, on a few rays: measured on the card, 1.2e-3 on
one ray of the 48^3 float32 scene); K2: atol 1e-5; K3: within 1e-5, after ``floor(T * 255) / 255``
equal on all but 0.1 % of voxels; K4: step counts equal on >= 99 % of pixels, there mean
within 1e-5 and m2 within 1e-4 of their largest values; K5: latents within
atol 1e-6, omega and alpha within 1e-5 (alpha modulo 2 pi, plus two ulps of
its cosine times acos' slope); K7a: found flags and attempt counts equal
on >= 99.5 % of samples, positions within 1e-4 where the attempts agree;
K7b: counts equal, per-point sums within 1e-5 (x) and 1e-4 (x^2) of their
largest values.
"""

import ctypes
import dataclasses
import math

import numpy as np
import pytest
import torch

from deepestscatter_tpu_torch import (BakedRenderer, build_scene, config, cuda_build, tasks,
                                      with_baked_inscatter)
from deepestscatter_tpu_torch.data import collectors, procedural, scenesetups
from deepestscatter_tpu_torch.scene import params_to
from deepestscatter_tpu_torch.models.probes import init_light_probe_model, init_probe_renderer_model
from deepestscatter_tpu_torch.ops import descriptor, march
from deepestscatter_tpu_torch.probes import gather
from deepestscatter_tpu_torch.render import baked, camera, inscatter, pathtracer
from deepestscatter_tpu_torch.utils import exr


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel tests run on the card)")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=["float32", "uint8"])
def scene(card, request):
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        camera=config.CameraConfig(width=96, height=48),
        rendering=config.CloudRendering(march_dtype=request.param),
    )
    params, static = build_scene(cfg, procedural.cumulus(48, seed=11), device=card)
    return cfg, params, static


def test_bake_kernel_matches_plain(scene):
    _, params, static = scene
    got = inscatter.sun_transmittance(params, static)
    ref = inscatter.sun_transmittance_plain(params, static)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-5
    q = lambda t: torch.floor(t * 255.0) / 255.0  # noqa: E731
    assert (q(got) != q(ref)).float().mean().item() <= 1e-3


def _camera_rays(cfg, params, static, card):
    o, d = camera.generate_rays(camera.camera_basis(cfg.camera), cfg.camera.width, cfg.camera.height, card)
    hit, t_hit = camera.intersect_box(o, d, static, params.bbox_size)
    entry = camera.entry_points(o, d, t_hit, params.bbox_size)
    idx = torch.nonzero(hit).flatten()
    return entry[idx].contiguous(), d[idx].contiguous(), idx


def _march_matches_plain(params, static, entry, dirs, ids, scatters=True):
    """K1 against its plain version, both passes: T bitwise, pass 2's flags
    and positions within the tolerances above."""
    k1 = march.camera_march(params, static, entry, dirs)
    p1 = march.camera_march_plain(params, static, entry, dirs)
    torch.cuda.synchronize()
    assert torch.equal(k1.transmittance, p1.transmittance)
    k2 = march.camera_march(params, static, entry, dirs, 7, ids, p1.transmittance)
    p2 = march.camera_march_plain(params, static, entry, dirs, 7, ids, p1.transmittance)
    torch.cuda.synchronize()
    assert torch.equal(k2.transmittance, p2.transmittance)
    agree = k2.ok == p2.ok
    assert agree.float().mean().item() >= 0.995
    both = k2.ok & p2.ok
    assert (both.sum().item() > 0) == scatters
    if scatters:
        assert (k2.scatter_pos - p2.scatter_pos)[both].abs().max().item() <= 1e-4
    return k1, k2


def test_march_kernel_matches_plain(scene, card):
    cfg, params, static = scene
    params = with_baked_inscatter(params, static, device=card)
    _march_matches_plain(params, static, *_camera_rays(cfg, params, static, card))


def _smooth_grid():
    """A 20 x 28 x 36 ([Z, Y, X]) grid of smooth random density: a box that
    is not a power of two in y and z (IEEE divisions)."""
    rng = np.random.default_rng(7)
    raw = rng.random((20, 28, 36)).astype(np.float32)
    smooth = (raw + np.roll(raw, 1, 0) + np.roll(raw, 1, 1) + np.roll(raw, 1, 2)) / 4.0
    return np.clip(smooth * 1.5 - 0.5, 0.0, None).astype(np.float32)


@pytest.fixture(scope="module", params=["float32", "uint8"])
def non_cubic(card, request):
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        camera=config.CameraConfig(width=96, height=48),
        rendering=config.CloudRendering(march_dtype=request.param),
    )
    params, static = build_scene(cfg, _smooth_grid(), device=card)
    return cfg, with_baked_inscatter(params, static, device=card), static


def test_march_kernel_non_cubic_grid(non_cubic, card):
    cfg, params, static = non_cubic
    assert static.grid_shape == (20, 28, 36)
    _march_matches_plain(params, static, *_camera_rays(cfg, params, static, card))


@pytest.mark.parametrize("n", [5, 1001])
def test_march_kernel_ragged_ray_counts(scene, card, n):
    """Five rays, fewer than a warp's lanes (one warp of four rays and one
    more), and 1001, which fill no whole block (16 rays a 128-thread
    block)."""
    cfg, params, static = scene
    params = with_baked_inscatter(params, static, device=card)
    entry, dirs, ids = _camera_rays(cfg, params, static, card)
    start = entry.shape[0] // 2 - n // 2
    rays = [t[start:start + n].contiguous() for t in (entry, dirs, ids)]
    assert rays[0].shape[0] == n
    _march_matches_plain(params, static, *rays)


def test_march_kernel_all_rays_miss_the_cloud(scene, card):
    """Rays inside the box along its bottom edge and from outside it: none
    meets the cloud AABB, T = 1 and no scatter."""
    _, params, static = scene
    params = with_baked_inscatter(params, static, device=card)
    n = 70
    t = torch.linspace(0.0, 1.0, n, device=card)
    entry = torch.stack([t, torch.zeros_like(t), torch.zeros_like(t)], dim=-1)
    entry[n // 2:, 0] = -0.5  # outside the box
    dirs = torch.tensor([[0.0, 0.0, 1.0]], device=card).expand(n, 3).contiguous()
    k1, k2 = _march_matches_plain(params, static, entry.contiguous(), dirs,
                                  torch.arange(n, device=card), scatters=False)
    assert bool((k1.transmittance == 1.0).all()) and not bool(k2.ok.any())


def test_march_kernel_axis_parallel_rays(scene, card):
    """Rays along +x, -y and +z through the cloud (safe_dir's 1e-9 on the
    zero components)."""
    _, params, static = scene
    params = with_baked_inscatter(params, static, device=card)
    g = torch.linspace(0.3, 0.7, 8, device=card)
    a, b = torch.meshgrid(g, g, indexing="ij")
    a, b = a.flatten(), b.flatten()
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    entry = torch.cat([torch.stack([zero, a, b], -1), torch.stack([a, one, b], -1),
                       torch.stack([a, b, zero], -1)]).contiguous()
    dirs = torch.cat([torch.tensor([[1.0, 0.0, 0.0]], device=card).expand(64, 3),
                      torch.tensor([[0.0, -1.0, 0.0]], device=card).expand(64, 3),
                      torch.tensor([[0.0, 0.0, 1.0]], device=card).expand(64, 3)]).contiguous()
    k1, _ = _march_matches_plain(params, static, entry, dirs, torch.arange(192, device=card))
    assert bool((k1.transmittance < 1.0).any())


def _descriptor_equal(params, static, pos, view):
    got = descriptor.network_inputs(params, static, pos, view)
    ref = descriptor.network_inputs_plain(params, static, pos, view)
    torch.cuda.synchronize()
    assert got.shape == (pos.shape[0], 10, 226)
    assert torch.equal(got, ref)
    return got


def _points(n, lo, hi, bbox, card, seed=0):
    rng = np.random.default_rng(seed)
    pos = (rng.uniform(lo, hi, (n, 3)) * bbox.cpu().numpy()).astype(np.float32)
    view = rng.normal(size=(n, 3)).astype(np.float32)
    view = view / np.linalg.norm(view, axis=-1, keepdims=True)
    return torch.as_tensor(pos, device=card), torch.as_tensor(view, device=card)


def test_descriptor_kernel_matches_plain(scene, card):
    _, params, static = scene
    _descriptor_equal(params, static, *_points(512, -0.05, 1.05, params.bbox_size, card))


@pytest.mark.parametrize("m", [1, 300])
def test_descriptor_kernel_ragged_point_counts(scene, card, m):
    """One point, and 300 points (67,800 columns: no whole number of
    256-thread blocks)."""
    _, params, static = scene
    _descriptor_equal(params, static, *_points(m, 0.1, 0.9, params.bbox_size, card, seed=m))


def test_descriptor_kernel_non_cubic_grid(non_cubic, card):
    _, params, static = non_cubic
    _descriptor_equal(params, static, *_points(512, -0.05, 1.05, params.bbox_size, card))


def test_descriptor_kernel_points_outside_the_box(scene, card):
    """Every point beyond the box: the fade zeroes what lies more than a
    mip voxel out."""
    _, params, static = scene
    pos, view = _points(256, 1.2, 1.6, params.bbox_size, card, seed=5)
    pos[128:] = -pos[128:]
    got = _descriptor_equal(params, static, pos, view)
    assert bool((got[:, 0, :225] == 0.0).all())


def test_wrappers_count_launches(scene):
    _, params, static = scene
    before = inscatter.sun_transmittance.launches
    inscatter.sun_transmittance(params, static)
    inscatter.sun_transmittance_plain(params, static)
    assert inscatter.sun_transmittance.launches == before + 1


@pytest.mark.parametrize("mode", list(config.RenderMode))
def test_pathtrace_kernel_matches_plain(scene, card, mode):
    cfg, params, static = scene
    params = with_baked_inscatter(params, static, device=card)
    static = dataclasses.replace(static, mode=mode, max_depth=40)
    o, d = camera.generate_rays(camera.camera_basis(cfg.camera), cfg.camera.width, cfg.camera.height, card)
    hit, t_hit = camera.intersect_box(o, d, static, params.bbox_size)
    entry = camera.entry_points(o, d, t_hit, params.bbox_size)
    ids = torch.arange(o.shape[0], device=card)
    got = pathtracer.scatter_loop(params, static, entry, d, hit, ids, 5, 1, 3)
    ref = pathtracer.scatter_loop_plain(params, static, entry, d, hit, ids, 5, 1, 3)
    torch.cuda.synchronize()
    assert torch.equal(got.count, ref.count)
    assert int(ref.bounces.sum()) > 0
    same = got.steps == ref.steps
    assert same.float().mean().item() >= 0.99
    for a, b, tol in ((got.mean, ref.mean, 1e-5), (got.m2, ref.m2, 1e-4)):
        scale = b.abs().max().item() + 1e-12
        assert (a - b)[same].abs().max().item() <= tol * scale


def test_pathtrace_kernel_step_cap(scene, card):
    """A sample cut at the step cap still counts: every hit pixel folds
    all its samples, and no sample marches past the cap."""
    cfg, params, static = scene
    params = with_baked_inscatter(params, static, device=card)
    o, d = camera.generate_rays(camera.camera_basis(cfg.camera), cfg.camera.width, cfg.camera.height, card)
    hit, t_hit = camera.intersect_box(o, d, static, params.bbox_size)
    entry = camera.entry_points(o, d, t_hit, params.bbox_size)
    ids = torch.arange(o.shape[0], device=card)
    got = pathtracer.scatter_loop(params, static, entry, d, hit, ids, 5, 1, 2, max_steps=30)
    ref = pathtracer.scatter_loop_plain(params, static, entry, d, hit, ids, 5, 1, 2, max_steps=30)
    assert torch.equal(got.count, ref.count)
    assert torch.equal(got.count[hit], torch.full_like(got.count[hit], 2.0))
    assert int(got.steps.max()) <= 60
    assert torch.equal(got.steps, ref.steps)


@pytest.mark.parametrize("kind, run", [("per_lane", 0), ("coalesced", 8), ("coalesced", 32)])
@pytest.mark.parametrize("width", [16, 1024])
def test_gather_probe_kernels_match_plain(card, kind, run, width):
    rows, idx = gather.make_case(kind, 4096, width, 8192, run=run or 32, device=card)
    if kind == "per_lane":
        got, ref = gather.per_lane(idx, rows, width), gather.per_lane_plain(idx, rows, width)
    else:
        got, ref = gather.coalesced(idx, rows, width, run), gather.coalesced_plain(idx, rows, width, run)
    torch.cuda.synchronize()
    assert got.shape == (8, 1)
    assert torch.equal(got, ref)


def _k4_equal_steps(params, static, entry, dirs, hit, ids, n_samples, max_steps=None):
    """K4 against its plain version: counts and step counts equal, mean
    and m2 within the tolerances above."""
    got = pathtracer.scatter_loop(params, static, entry, dirs, hit, ids, 5, 1, n_samples, max_steps)
    ref = pathtracer.scatter_loop_plain(params, static, entry, dirs, hit, ids, 5, 1, n_samples,
                                        max_steps)
    torch.cuda.synchronize()
    assert torch.equal(got.count, ref.count)
    assert torch.equal(got.steps, ref.steps)
    assert torch.equal(got.bounces, ref.bounces)
    for a, b, tol in ((got.mean, ref.mean, 1e-5), (got.m2, ref.m2, 1e-4)):
        assert (a - b).abs().max().item() <= tol * (b.abs().max().item() + 1e-12)
    return got, ref


def _pt_rays(cfg, params, static, card):
    o, d = camera.generate_rays(camera.camera_basis(cfg.camera), cfg.camera.width, cfg.camera.height, card)
    hit, t_hit = camera.intersect_box(o, d, static, params.bbox_size)
    entry = camera.entry_points(o, d, t_hit, params.bbox_size)
    return entry, d, hit, torch.arange(o.shape[0], device=card)


@pytest.mark.parametrize("n_samples", [1, 4])
def test_pathtrace_kernel_sample_counts(scene, card, n_samples):
    cfg, params, static = scene
    params = with_baked_inscatter(params, static, device=card)
    static = dataclasses.replace(static, max_depth=40)
    got, _ = _k4_equal_steps(params, static, *_pt_rays(cfg, params, static, card), n_samples)
    assert int(got.bounces.sum()) > 0


@pytest.mark.parametrize("n", [7, 45, 1000])
def test_pathtrace_kernel_ragged_pixel_counts(scene, card, n):
    """N below one warp and N not a multiple of 32 (hit and missed pixels
    mixed)."""
    cfg, params, static = scene
    params = with_baked_inscatter(params, static, device=card)
    static = dataclasses.replace(static, max_depth=40)
    entry, d, hit, ids = _pt_rays(cfg, params, static, card)
    # A run of neighbouring pixels from just before the first box hit.
    start = max(int(torch.nonzero(hit)[0, 0]) - n // 4, 0)
    rays = [t[start:start + n].contiguous() for t in (entry, d, hit, ids)]
    assert bool(rays[2].any()) and rays[0].shape[0] == n
    _k4_equal_steps(params, static, *rays, 3)


def test_pathtrace_kernel_all_pixels_miss(scene, card):
    cfg, params, static = scene
    params = with_baked_inscatter(params, static, device=card)
    entry, d, hit, ids = _pt_rays(cfg, params, static, card)
    got, _ = _k4_equal_steps(params, static, entry, d, torch.zeros_like(hit), ids, 2)
    assert int(got.count.sum()) == 0 and int(got.steps.sum()) == 0
    assert pathtracer.scatter_loop.last_counters[0].item() >= entry.shape[0] * 2


@pytest.mark.parametrize("max_steps", [1, 27, 30])
def test_pathtrace_kernel_cap_inside_a_chunk(scene, card, max_steps):
    """A step cap that ends samples inside a lookahead chunk."""
    cfg, params, static = scene
    params = with_baked_inscatter(params, static, device=card)
    rays = _pt_rays(cfg, params, static, card)
    got, _ = _k4_equal_steps(params, static, *rays, 3, max_steps)
    full = pathtracer.scatter_loop(params, static, *rays, 5, 1, 3)
    assert bool((got.steps < full.steps).any())
    assert int(got.steps.max()) <= 3 * max_steps


@pytest.mark.parametrize("light", [(0.0, -1.0, 0.0), (0.48, -0.6, 0.64)], ids=["axis", "mixed"])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_bake_kernel_non_cubic_grid(card, dtype, light):
    """K3 on a 20 x 28 x 40 grid (rows of 40: not a multiple of the
    16-byte staging, and one block segment) and a 24 x 16 x 1040 grid (rows
    longer than one block's voxels), early-out on and off: bitwise equal
    to the plain version."""
    rng = np.random.default_rng(7)
    for shape in ((20, 28, 40), (24, 16, 1040)):
        raw = rng.random(shape).astype(np.float32)
        density = np.clip(raw * 1.5 - 0.5, 0.0, None)
        cfg = config.SceneConfig(
            cloud=config.CloudModel(size_m=2000.0),
            light=config.DirectionalLight(direction=light),
            rendering=config.CloudRendering(march_dtype=dtype),
        )
        params, static = build_scene(cfg, density, device=card)
        for early_out in (True, False):
            got = inscatter.sun_transmittance(params, static, early_out)
            ref = inscatter.sun_transmittance_plain(params, static, early_out)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (shape, early_out)


def test_new_wrappers_count_launches(scene, card):
    cfg, params, static = scene
    params = with_baked_inscatter(params, static, device=card)
    entry = torch.full((4, 3), 0.5, device=card)
    dirs = torch.tensor([[0.0, 0.0, 1.0]] * 4, device=card)
    hit = torch.ones(4, dtype=torch.bool, device=card)
    ids = torch.arange(4, device=card)
    before = pathtracer.scatter_loop.launches
    pathtracer.scatter_loop(params, static, entry, dirs, hit, ids, 0, 1, 1)
    pathtracer.scatter_loop_plain(params, static, entry, dirs, hit, ids, 0, 1, 1)
    assert pathtracer.scatter_loop.launches == before + 1
    rows, idx = gather.make_case("per_lane", 64, 16, 1024, device=card)
    _, cidx = gather.make_case("coalesced", 64, 16, 1024, run=8, device=card)
    p0, c0 = gather.per_lane.launches, gather.coalesced.launches
    gather.per_lane(idx, rows, 16)
    gather.coalesced(cidx, rows, 16, 8)
    gather.per_lane_plain(idx, rows, 16)
    gather.coalesced_plain(cidx, rows, 16, 8)
    assert (gather.per_lane.launches, gather.coalesced.launches) == (p0 + 1, c0 + 1)


@pytest.mark.parametrize("layers", [3, 9])
def test_descriptor_kernel_baked_layers(scene, card, layers):
    """K2 at the baked renderer's layer counts: 3 along the view, 9 in the
    frame of the probe direction (the bake's)."""
    _, params, static = scene
    pos, view = _points(700, -0.05, 1.05, params.bbox_size, card, seed=layers)
    frame = baked.probe_frames(700, card) if layers == 9 else None
    got = descriptor.network_inputs(params, static, pos, view, layers, frame)
    ref = descriptor.network_inputs_plain(params, static, pos, view, layers, frame)
    torch.cuda.synchronize()
    assert got.shape == (700, layers, 226)
    assert torch.equal(got, ref)


def _probe_inputs(params, card, dtype, n, seed=0):
    """A random 6 x 5 x 7 probe lattice of ``dtype`` and ``n`` points from
    5 % outside to 5 % beyond the box, with random views."""
    rng = np.random.default_rng(seed)
    shape = (7, 5, 6, baked.PROBE_LENGTH)
    if dtype == "uint8":
        probes = torch.as_tensor(rng.integers(0, 256, shape).astype(np.uint8), device=card)
    else:
        probes = torch.as_tensor(rng.random(shape).astype(np.float32), device=card)
    pos, view = _points(n, -0.05, 1.05, params.bbox_size, card, seed=seed + 1)
    return probes, pos, view


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("n", [1, 17, 5000])
def test_probe_kernel_matches_plain(scene, card, dtype, n):
    """K5 on one point, on 17 (a block of 16 points and one more) and on
    5,000: bitwise equal to its plain version."""
    _, params, static = scene
    probes, pos, view = _probe_inputs(params, card, dtype, n, seed=n)
    got = baked.interpolate_probes(params, static, probes, pos, view)
    ref = baked.interpolate_probes_plain(params, static, probes, pos, view)
    torch.cuda.synchronize()
    assert got.shape == (n, baked.PROBE_IN_WIDTH)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("width", [16, 48, 64, 1024, 2048])
def test_p1_rows_in_flight_match_plain(card, width):
    """P1 at a lane a row (16 B), two lanes with a masked vector (48 B),
    four lanes (64 B), a warp (1 KB) and a warp over two passes (2 KB)."""
    rows, idx = gather.make_case("per_lane", 3000, width, 16384, device=card)
    got = gather.per_lane(idx, rows, width)
    ref = gather.per_lane_plain(idx, rows, width)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_p1_designs_sum_exactly(card):
    report = gather.variants(cases=((4096, 1024, 8192), (4096, 16, 8192)), reps=1)
    for case in report.values():
        assert set(case) == set(gather.P1_DESIGNS)
        assert all(r["equal"] for r in case.values()), case


def test_baked_renderer_on_the_card(scene, card):
    """The BNN frame on the card: finite, deterministic per seed, different
    across seeds, through K1, K2 and K5."""
    cfg, params, static = scene
    params = with_baked_inscatter(params, static, device=card)
    renderer = BakedRenderer(params, static, init_light_probe_model(1, card),
                             init_probe_renderer_model(2, card), device=card)
    assert renderer.probes.dtype == torch.uint8 and renderer.probes.is_cuda
    basis = camera.camera_basis(cfg.camera)
    before = (march.camera_march.launches, descriptor.network_inputs.launches,
              baked.interpolate_probes.launches)
    frame = renderer.render_frame(params, static, 96, 48, basis, seed=3)
    after = (march.camera_march.launches, descriptor.network_inputs.launches,
             baked.interpolate_probes.launches)
    assert all(a > b for a, b in zip(after, before))
    assert frame.shape == (48, 96, 3) and bool(torch.isfinite(frame).all())
    assert torch.equal(frame, renderer.render_frame(params, static, 96, 48, basis, seed=3))
    assert not torch.equal(frame, renderer.render_frame(params, static, 96, 48, basis, seed=4))


def test_probe_wrapper_counts_launches(scene, card):
    _, params, static = scene
    probes, pos, view = _probe_inputs(params, card, "uint8", 8)
    before = baked.interpolate_probes.launches
    baked.interpolate_probes(params, static, probes, pos, view)
    baked.interpolate_probes_plain(params, static, probes, pos, view)
    assert baked.interpolate_probes.launches == before + 1


def test_probe_redesign_equals_first_design(scene, card):
    _, params, static = scene
    for dtype in ("uint8", "float32"):
        probes, pos, view = _probe_inputs(params, card, dtype, 4099, seed=9)
        got = baked.interpolate_probes(params, static, probes, pos, view)
        first = baked._launch(params, static, probes, pos, view, entry="ds_probes_first")
        torch.cuda.synchronize()
        assert torch.equal(got, first), dtype


@pytest.fixture(scope="module")
def collect_scene(card):
    """The 48^3 cumulus at 2000 m with uint8 textures, baked."""
    cfg = config.SceneConfig(cloud=config.CloudModel(size_m=2000.0),
                             rendering=config.CloudRendering(march_dtype="uint8"))
    params, static = build_scene(cfg, procedural.cumulus(48, seed=11), device=card)
    return with_baked_inscatter(params, static, device=card), static


def test_samples_kernel_matches_plain(collect_scene, card):
    params, static = collect_scene
    got = collectors._launch_samples(params, static, 777, 3)
    ref = collectors.generate_scatter_samples_plain(params, static, 777, 3)
    torch.cuda.synchronize()
    for name, a, b in zip(ref._fields, got, ref):
        assert torch.equal(a, b), name
    assert bool(got.found.all()) and int(got.attempts.max()) > 1


@pytest.fixture(scope="module")
def thin_scene(card):
    """The 24^3 cumulus at 2000 m, uint8, its density scaled by 0.003: an
    attempt scatters with a probability of ~1 %."""
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        rendering=config.CloudRendering(march_dtype="uint8", sample_step=1.0 / 64.0))
    params, static = build_scene(cfg, procedural.cumulus(24, seed=11), device=card)
    return params, dataclasses.replace(static,
                                       density_multiplier=static.density_multiplier * 0.003)


@pytest.fixture(scope="module")
def variants_lib(card):
    """The kernels' alternatives (``csrc/march_variants.cu``)."""
    import ctypes

    lib = cuda_build.load("march_variants")
    lib.ds_samples_variant.argtypes = [ctypes.c_int] * 2
    lib.ds_samples_variant.restype = None
    lib.ds_radiance_variant.argtypes = [ctypes.c_int] * 3
    lib.ds_radiance_variant.restype = None
    return lib


def test_samples_rounds_thin_cloud_match_plain(thin_scene, card, variants_lib):
    """Rounds of attempts against the plain loop where samples need up to
    256 attempts: bitwise, on the card and within the CPU tolerances
    against the CPU; and equal to the first design (a warp a sample)."""
    params, static = thin_scene
    got = collectors._launch_samples(params, static, 600, 5)
    ref = collectors.generate_scatter_samples_plain(params, static, 600, 5)
    torch.cuda.synchronize()
    for name, a, b in zip(ref._fields, got, ref):
        assert torch.equal(a, b), name
    w = cuda_build.load("samples").ds_sample_warps()
    assert int((got.found & (got.attempts > 256 - w)).sum()) > 0
    assert int((~got.found).sum()) > 0
    variants_lib.ds_samples_variant(0, 32)
    first = collectors._launch_samples(params, static, 600, 5, lib=variants_lib)
    for name, a, b in zip(ref._fields, first, got):
        assert torch.equal(a, b), name
    cpu = collectors.generate_scatter_samples_plain(params_to(params, "cpu"), static, 600, 5)
    assert (got.found.cpu() == cpu.found).float().mean().item() >= 0.995
    assert (got.attempts.cpu() == cpu.attempts).float().mean().item() >= 0.995


def test_radiance_deferred_equals_first_design(collect_scene, card, variants_lib):
    """K7b's deferred scatters against K4's item queue (its first design),
    records and folds bitwise: the package's, at 1 and 32 parked lanes and
    at lookahead 4; also with a cap of 27 steps an experiment (inside a
    chunk)."""
    params, static = collect_scene
    rs = dataclasses.replace(collectors.radiance_static(static), max_depth=200)
    entry, d, rids, base = _radiance_case(params, static, card)
    o, dd, ids, sub0 = collectors._lanes(entry, d, rids, base, 3, 4)
    sub32 = torch.where(sub0 >= 2**31, sub0 - 2**32, sub0).to(torch.int32).contiguous()
    hit = torch.ones(o.shape[0], dtype=torch.bool, device=card)

    def launch(lib, cap):
        pm, rec, _ = pathtracer.launch_entry(
            lib, "ds_radiance", pathtracer.RADIANCE_ARGTYPES, cuda_build.ptr(sub32), params, rs,
            o, dd, hit, ids, 9, 4, cap)
        return pm, rec

    for cap in (None, 27):
        variants_lib.ds_radiance_variant(0, 16, 2)
        want = launch(variants_lib, cap)
        runs = [launch(None, cap)]
        for variant in ((1, 1, 2), (1, 32, 2), (1, 16, 4)):
            variants_lib.ds_radiance_variant(*variant)
            runs.append(launch(variants_lib, cap))
        torch.cuda.synchronize()
        if cap is not None:
            assert int(want[1].work[..., 0].max()) == cap
        for pm, rec in runs:
            for a, b in zip(tuple(pm) + tuple(rec), tuple(want[0]) + tuple(want[1])):
                assert torch.equal(a, b)
    variants_lib.ds_radiance_variant(1, cuda_build.load("pathtrace").ds_radiance_park_at(), 2)


def test_samples_wrapper_counts_launches(collect_scene, card):
    params, static = collect_scene
    before = collectors.generate_scatter_samples.launches
    collectors.generate_scatter_samples(params, static, 64, 1)
    collectors.generate_scatter_samples_plain(params, static, 64, 1)
    assert collectors.generate_scatter_samples.launches == before + 1


def _radiance_case(params, static, card, n=96):
    s = collectors.generate_scatter_samples(params, static, n, 5)
    entry = (s.positions + 0.5 * params.bbox_size).contiguous()
    rids = torch.arange(n, device=card)
    base = torch.full((n,), 2**32 - 7, dtype=torch.int64, device=card)
    return entry, s.directions.contiguous(), rids, base


def test_radiance_kernel_matches_plain(collect_scene, card):
    """Per lane: counts, steps and scatters equal; each experiment's record
    equal to a one-experiment plain run with the base sub0 + k; then the
    per-point moments within K4's tolerances."""
    params, static = collect_scene
    rs = dataclasses.replace(collectors.radiance_static(static), max_depth=200)
    entry, d, rids, base = _radiance_case(params, static, card)
    o, dd, ids, sub0 = collectors._lanes(entry, d, rids, base, 3, 4)
    hit = torch.ones(o.shape[0], dtype=torch.bool, device=card)
    before = collectors.radiance_moments.launches
    got, rec = collectors.launch_radiance(params, rs, o, dd, ids, sub0, 9, 4)
    assert collectors.radiance_moments.launches == before + 1
    ref = pathtracer.scatter_loop_plain(params, rs, o, dd, hit, ids, 9, sub0, 4)
    torch.cuda.synchronize()
    assert torch.equal(got.count, ref.count)
    assert torch.equal(got.steps, ref.steps) and torch.equal(got.bounces, ref.bounces)
    k = torch.arange(4, device=card)
    one = pathtracer.scatter_loop_plain(
        params, rs, o.repeat(4, 1), dd.repeat(4, 1), hit.repeat(4), ids.repeat(4), 9,
        ((sub0[None, :] + k[:, None]) & 0xFFFFFFFF).reshape(-1), 1)
    assert torch.equal(torch.stack([one.steps, one.bounces], dim=1),
                       rec.work.reshape(-1, 2).long())
    peak = one.mean.abs().max().item()
    assert (rec.radiance.reshape(-1, 3) - one.mean).abs().max().item() <= 1e-5 * (peak + 1e-12)
    m = collectors.radiance_moments(params, rs, entry, d, rids, base, 9, 3, 4)
    p = collectors.radiance_moments_plain(params, rs, entry, d, rids, base, 9, 3, 4)
    assert torch.equal(m[0], p[0])
    for a, b, tol in ((m[1], p[1], 1e-5), (m[2], p[2], 1e-4)):
        assert (a - b).abs().max().item() <= tol * (b.abs().max().item() + 1e-12)


def test_collect_on_the_card(card, tmp_path):
    """The four stages through ``tasks.collect`` on two small scenes: every
    table full, samples in the box with unit directions, labels finite and
    non-negative, powers summing to 1; CONTINUE then finds nothing to do."""
    triplet = scenesetups.generate(str(tmp_path), ["procedural:32:3", "procedural:32:4"],
                                   seed=1, scenes_per_cloud=2)
    store = next(s for s in (triplet.train, triplet.validation, triplet.test)
                 if s.count("SceneSetup") >= 2)
    rc = config.PointRadianceConfig(max_threads=1024, launches_per_update=8, rel_tol=0.2,
                                    abs_tol=1e-3, black_min_experiments=500)
    for rt in ("ScatterSample", "Result", "DisneyDescriptor", "BakedInterpolationSet"):
        n = tasks.collect(store, rt, tasks.CollectMode.OVERWRITE, radiance_cfg=rc,
                          batch_size=128, max_scenes=2, verbose=False, device=card)
        assert n == 2 and store.count(rt) == 256
    samples = store.table("ScatterSample").read(0, 256)
    assert np.all(np.abs(samples["point"]) <= 0.51)
    assert np.allclose(np.linalg.norm(samples["view_direction"], axis=1), 1.0, atol=1e-5)
    labels = store.table("Result").read(0, 256)["light_intensity"]
    assert np.all(np.isfinite(labels)) and labels.min() >= 0.0 and labels.mean() > 0.0
    sets = store.table("BakedInterpolationSet").read(0, 256)
    assert np.allclose(sum(sets[c]["power"] for c in "abcd"), 1.0, atol=1e-4)
    assert tasks.collect(store, "ScatterSample", tasks.CollectMode.CONTINUE, batch_size=128,
                         max_scenes=2, verbose=False, device=card) == 0


# -- the card against the CPU ------------------------------------------------


def _cpu(*tensors):
    return tuple(t.cpu() for t in tensors)


def test_k1_card_matches_cpu(scene, card):
    cfg, params, static = scene
    params = with_baked_inscatter(params, static, device=card)
    entry, dirs, ids = _camera_rays(cfg, params, static, card)
    cpu = params_to(params, "cpu")
    k1 = march.camera_march(params, static, entry, dirs)
    c1 = march.camera_march_plain(cpu, static, *_cpu(entry, dirs))
    t = k1.transmittance.cpu()
    assert (t - c1.transmittance).abs().max().item() <= 1e-5
    k2 = march.camera_march(params, static, entry, dirs, 7, ids, k1.transmittance)
    c2 = march.camera_march_plain(cpu, static, *_cpu(entry, dirs), 7, ids.cpu(), t)
    ok = k2.ok.cpu()
    assert (ok == c2.ok).float().mean().item() >= 0.995
    both = ok & c2.ok
    assert int(both.sum()) > 0
    near = ((k2.scatter_pos.cpu() - c2.scatter_pos)[both].abs().amax(dim=-1) <= 1e-4)
    assert near.float().mean().item() >= 0.995


def test_k2_card_matches_cpu(scene, card):
    _, params, static = scene
    pos, view = _points(700, -0.05, 1.05, params.bbox_size, card, seed=21)
    got = descriptor.network_inputs(params, static, pos, view).cpu()
    ref = descriptor.network_inputs_plain(params_to(params, "cpu"), static, *_cpu(pos, view))
    assert (got - ref).abs().max().item() <= 1e-5


def test_k3_card_matches_cpu(scene, card):
    _, params, static = scene
    got = inscatter.sun_transmittance(params, static).cpu()
    ref = inscatter.sun_transmittance_plain(params_to(params, "cpu"), static)
    assert (got - ref).abs().max().item() <= 1e-5
    q = lambda t: torch.floor(t * 255.0) / 255.0  # noqa: E731
    assert (q(got) != q(ref)).float().mean().item() <= 1e-3


def test_k4_card_matches_cpu(scene, card):
    cfg, params, static = scene
    params = with_baked_inscatter(params, static, device=card)
    static = dataclasses.replace(static, max_depth=10)
    entry, d, hit, ids = _pt_rays(cfg, params, static, card)
    sub = slice(0, entry.shape[0], 7)
    args = (entry[sub].contiguous(), d[sub].contiguous(), hit[sub].contiguous(),
            ids[sub].contiguous())
    got = pathtracer.scatter_loop(params, static, *args, 5, 1, 2)
    ref = pathtracer.scatter_loop_plain(params_to(params, "cpu"), static, *_cpu(*args), 5, 1, 2)
    assert torch.equal(got.count.cpu(), ref.count)
    same = got.steps.cpu() == ref.steps
    assert same.float().mean().item() >= 0.99
    for a, b, tol in ((got.mean.cpu(), ref.mean, 1e-5), (got.m2.cpu(), ref.m2, 1e-4)):
        assert (a - b)[same].abs().max().item() <= tol * (b.abs().max().item() + 1e-12)


def angle_close(a, b, tol=1e-5):
    """Angles within ``tol`` modulo 2 pi, plus two float32 ulps of the
    cosine times acos' slope."""
    d = (a - b).abs()
    d = torch.minimum(d, 2.0 * math.pi - d)
    slope = 1.0 / torch.sqrt(torch.clamp(1.0 - torch.cos(b) ** 2, min=1e-12))
    return d <= tol + 2.0 * 1.2e-7 * slope


def test_k5_card_matches_cpu(scene, card):
    _, params, static = scene
    for dtype in ("uint8", "float32"):
        probes, pos, view = _probe_inputs(params, card, dtype, 3000, seed=31)
        got = baked.interpolate_probes(params, static, probes, pos, view).cpu()
        ref = baked.interpolate_probes_plain(params_to(params, "cpu"), static,
                                             *_cpu(probes, pos, view))
        w = baked.PROBE_LENGTH
        assert (got[:, :w] - ref[:, :w]).abs().max().item() <= 1e-6, dtype
        assert bool(angle_close(got[:, w:], ref[:, w:]).all()), dtype


def test_k7a_card_matches_cpu(collect_scene, card):
    params, static = collect_scene
    got = collectors.generate_scatter_samples(params, static, 512, 4)
    ref = collectors.generate_scatter_samples_plain(params_to(params, "cpu"), static, 512, 4)
    found = got.found.cpu()
    assert (found == ref.found).float().mean().item() >= 0.995
    assert (got.attempts.cpu() == ref.attempts).float().mean().item() >= 0.995
    same = (got.attempts.cpu() == ref.attempts) & found & ref.found
    assert (got.positions.cpu() - ref.positions)[same].abs().max().item() <= 1e-4


def test_k7b_card_matches_cpu(collect_scene, card):
    params, static = collect_scene
    rs = dataclasses.replace(collectors.radiance_static(static), max_depth=50)
    entry, d, rids, base = _radiance_case(params, static, card, n=48)
    got = collectors.radiance_moments(params, rs, entry, d, rids, base, 9, 2, 3)
    ref = collectors.radiance_moments_plain(params_to(params, "cpu"), rs,
                                            *_cpu(entry, d, rids, base), 9, 2, 3)
    assert torch.equal(got[0].cpu(), ref[0])
    for a, b, tol in ((got[1].cpu(), ref[1], 1e-5), (got[2].cpu(), ref[2], 1e-4)):
        assert (a - b).abs().max().item() <= tol * (b.abs().max().item() + 1e-12)


def _k10_tables(n=2048, seed=11):
    g = torch.Generator().manual_seed(seed)
    u8 = lambda w: torch.randint(0, 256, (n, w), generator=g, dtype=torch.uint8)  # noqa: E731
    f = lambda *sh: torch.rand(*sh, generator=g)  # noqa: E731
    return dict(grids=u8(10 * 225), probes=u8(4 * 9 * 225), rt=u8(3 * 225), powers=f(n, 4),
                omega=f(n), alpha=f(n), labels=f(n))


def _k10(tables, idx, layout, plain=False):
    """K10's wrapper (or its plain version) of ``layout`` on ``tables``."""
    from deepestscatter_tpu_torch.train import device_data

    fn = getattr(device_data, f"assemble_{layout}" + ("_plain" if plain else ""))
    if layout == "disney":
        return fn(tables["grids"], tables["omega"], tables["labels"], idx)
    return fn(*(tables[k] for k in ("probes", "rt", "powers", "omega", "alpha", "labels")), idx)


@pytest.mark.parametrize("layout", ["disney", "baked"])
def test_k10_matches_plain(card, layout):
    from deepestscatter_tpu_torch.train import device_data

    cpu = _k10_tables()
    t = {k: v.to(card) for k, v in cpu.items()}
    idx = torch.randint(0, 2048, (1024,), generator=torch.Generator().manual_seed(5)).to(card)
    counter = getattr(device_data, f"assemble_{layout}")
    before = counter.launches
    got = _k10(t, idx, layout)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    ref = _k10(t, idx, layout, plain=True)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    on_cpu = _k10(cpu, idx.cpu(), layout, plain=True)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, on_cpu))


def test_k10_rows_outside_the_table_are_nan(card):
    t = {k: v.to(card) for k, v in _k10_tables().items()}
    idx = torch.tensor([3, 2048, -1, 4], dtype=torch.int64, device=card)
    bad = torch.tensor([False, True, True, False], device=card)
    for layout in ("disney", "baked"):
        out = _k10(t, idx, layout)
        assert all(bool(o[bad].isnan().all()) and not bool(o[~bad].isnan().any()) for o in out)


def test_amsgrad_card_matches_cpu(card):
    from deepestscatter_tpu_torch.train import trainer

    g = torch.Generator().manual_seed(2)
    shapes = [(200, 226), (200,), (1, 200), (1,)]
    p_cpu = [torch.randn(s, generator=g) for s in shapes]
    p_card = [p.to(card) for p in p_cpu]
    a, b = trainer.AmsGrad(p_cpu, 1e-3), trainer.AmsGrad(p_card, 1e-3)
    for _ in range(5):
        grads = [torch.randn(s, generator=g) * 10.0 ** torch.empty(s).uniform_(-6, 0, generator=g)
                 for s in shapes]
        ua = a.updates(grads)
        ub = b.updates([x.to(card) for x in grads]).cpu()
        assert bool(((ua - ub).abs() <= 1e-6 * ua.abs()).all())


def test_train_step_card_matches_cpu(card):
    from deepestscatter_tpu_torch.models.blocks import flax_init
    from deepestscatter_tpu_torch.models.rpnn import DisneyModel
    from deepestscatter_tpu_torch.render.neural import exact_float32_matmul
    from deepestscatter_tpu_torch.train import trainer

    exact_float32_matmul()
    g = torch.Generator().manual_seed(4)
    z = torch.rand(5, 256, 10, 226, generator=g)
    labels = torch.rand(5, 256, generator=g) * 3.0
    apply_fn = lambda m, b: m(b["z_layers"])  # noqa: E731
    losses = []
    for dev in ("cpu", card):
        model = flax_init(DisneyModel(), 566, dev)
        opt = trainer.AmsGrad(list(model.parameters()), 1e-3)
        losses.append(torch.stack([
            trainer.train_step(model, opt, apply_fn, {"z_layers": z[i].to(dev)}, labels[i].to(dev))
            for i in range(5)]).cpu())
    assert bool(((losses[0] - losses[1]).abs() <= 1e-4 * losses[0].abs()).all())


@pytest.mark.parametrize("kind", ["nn", "bnn"])
def test_render_cloud_card_matches_cpu(card, kind, tmp_path):
    """``tasks.render_cloud`` from ``.pt`` exports of ``flax_init(566)``
    weights on the card and on the CPU: the frames within rtol 1e-3 (atol
    1e-6 of the largest value) on >= 99.5 % of pixels (a scatter flag may
    flip where the devices' float functions differ in the last bit)."""
    from deepestscatter_tpu_torch.train import trainer

    weights = tasks.load_neural_weights(kind, ":init:", device="cpu")
    for name, model in weights.items():
        trainer.save_state(str(tmp_path / "runs" / f"{name}.pt"), trainer.cpu_state_dict(model))
    base = dataclasses.replace(tasks.production_base(),
                               camera=config.CameraConfig(width=64, height=32))
    frames = []
    for dev in (card, "cpu"):
        (path,) = tasks.render_cloud("procedural:32:3", str(tmp_path / str(dev)), kind, 800.0,
                                     directions=("Side",), base=base,
                                     models_dir=str(tmp_path / "runs"), verbose=False, device=dev)
        frames.append(exr.read_exr(path))
    got, ref = frames
    assert got.shape == ref.shape == (32, 64, 3) and np.all(np.isfinite(got))
    assert np.abs(ref).max() > 0
    close = np.isclose(got, ref, rtol=1e-3, atol=1e-6 * np.abs(ref).max()).all(axis=-1)
    assert close.mean() >= 0.995


# -- the differentiable renderer: K3's forward, K8a, K8b ------------------------

#: A small frame of the defaults point's kind on a 24^3 cumulus (steps of
#: 1/128 to 1.75, past the box diagonal).
DIFF_KW = dict(width=32, height=16, density_multiplier=100.0, n_steps=224, sun_steps=64,
               sample_step=1.0 / 128.0, remat_chunk=32,
               sun_cos_half_angle=math.cos(math.radians(0.53) / 2.0))
#: Image relative to its largest value; gradients each relative to theirs.
DIFF_TOL = {"image": 1e-5, "density": 1e-4, "sun_dir": 1e-3, "eye": 1e-3, "look_at": 1e-3,
            "light_radiance": 1e-3}


def _diff_scene(dev, res=24):
    from deepestscatter_tpu_torch.ops import grid as grid_ops
    from deepestscatter_tpu_torch.render import diff

    density = grid_ops.normalize_density(procedural.cumulus(resolution=res, seed=29))
    return diff.diff_scene_from_numpy(
        density, np.asarray([-0.3, -0.9, 0.1], np.float32),
        np.asarray([2.5, -0.4, 0.0], np.float32), np.zeros(3, np.float32),
        np.full(3, 1e6, np.float32), device=dev)


def _diff_grads(scene, baked, kernels):
    from deepestscatter_tpu_torch.render import diff

    leaves = [t.detach().clone().requires_grad_(True) for t in scene]
    kw = dict(DIFF_KW, use_baked_inscatter=baked)
    if kernels:
        img = diff.render_single_scatter(diff.DiffScene(*leaves), device=scene.density.device,
                                         **kw)
    else:
        img = diff.render_single_scatter_plain(diff.DiffScene(*leaves), **kw)
    return [img.detach()] + list(torch.autograd.grad(img.mean(), leaves))


def _diff_close(got, want):
    for name, a, b in zip(DIFF_TOL, got, want):
        a, b = a.double().cpu(), b.double().cpu()
        assert float((a - b).abs().max()) <= DIFF_TOL[name] * float(b.abs().max()), name


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("baked", [True, False], ids=["baked", "pointwise"])
def test_diff_kernels_match_plain(card, baked):
    """The render's image and gradients through the kernels against the
    plain versions; then each kernel on the render's own inputs: K8b's
    forward (G lanes a ray) bitwise equal to the plain march and to its
    first design, a thread a ray (``csrc/diff_variants.cu``; the step
    counts too); K8b's adjoint (G lanes a ray) against autograd of the
    plain march (within 1e-5 of each leaf's largest) and against its first
    design, a thread a ray (within 1e-5); K8a (rows) against autograd of
    the plain bake (1e-6) and its first design, a thread a voxel (the same
    float32 terms in float64 sums: 1e-12)."""
    from deepestscatter_tpu_torch.render import diff

    scene = _diff_scene(card)
    got = _diff_grads(scene, baked, kernels=True)
    assert float(got[0].max()) > 0 and all(bool(torch.isfinite(t).all()) for t in got)
    _diff_close(got, _diff_grads(scene, baked, kernels=False))

    variants = cuda_build.load("diff_variants")
    variants.ds_diff_variant.argtypes = [ctypes.c_int] * 3
    variants.ds_diff_forward_variant.argtypes = [ctypes.c_int] * 3
    kw = dict(DIFF_KW, use_baked_inscatter=baked)
    with torch.no_grad():
        m = diff.march_setup(scene, kernels=True, **kw)
    args = (scene.density, m.baked, None if m.to_sun is None else m.to_sun.contiguous(),
            m.entry.contiguous(), m.dirs.contiguous(), m.p_phase.contiguous(),
            m.hit.to(torch.uint8), m.meta)
    g = torch.from_numpy(np.random.default_rng(9).random(m.hit.shape[0]).astype(np.float32))
    g = torch.where(m.hit, g.to(card), 0.0).contiguous()
    n = m.hit.shape[0]
    steps = torch.zeros((n, 3), dtype=torch.int32, device=card)
    rad = diff.launch_march(*args, steps=steps)
    with torch.no_grad():
        plain = diff.quadrature_march_plain(*args[:6], m.meta, kw["remat_chunk"])
    assert torch.equal(rad[m.hit], plain[m.hit]) and bool((rad[~m.hit] == 0).all())
    first_steps = torch.zeros_like(steps)
    variants.ds_diff_forward_variant(0, 1, 1)  # the forward's first design
    first_rad = diff.launch_march(*args, steps=first_steps, lib=variants)
    assert torch.equal(rad, first_rad) and torch.equal(steps, first_steps)
    assert int(steps[:, 1].sum()) > 0 and (int(steps[:, 2].sum()) > 0) == (not baked)
    back = diff.launch_march_bwd(*args[:7], rad, g, m.meta)
    variants.ds_diff_variant(4, 0, 0)
    first = diff.launch_march_bwd(*args[:7], rad, g, m.meta, lib=variants)
    names = ["density", "entry", "dirs", "p_phase", "baked" if baked else "to_sun"]
    leaves = {n: (getattr(scene, n) if n == "density" else getattr(m, n)).detach().clone()
              .requires_grad_(True) for n in names}
    ref = diff.quadrature_march_plain(leaves["density"], leaves.get("baked"),
                                      leaves.get("to_sun"), leaves["entry"], leaves["dirs"],
                                      leaves["p_phase"], m.meta, kw["remat_chunk"])
    want = dict(zip(names, torch.autograd.grad(ref, list(leaves.values()), g)))
    for name in names:
        assert _rel(getattr(back, name), want[name]) <= 1e-5, name
        assert _rel(getattr(back, name), getattr(first, name)) <= 1e-5, name
    if not baked:
        return
    sun_n = scene.sun_dir / torch.linalg.norm(scene.sun_dir)
    light = tuple(sun_n.tolist())
    trans = inscatter.launch_bake(scene.density, m.meta.bbox, light, m.meta.step,
                                  m.meta.density_multiplier, False)
    adj = (scene.density, m.meta.bbox, light, m.meta.density_multiplier, m.meta.step, trans,
           back.baked.reshape(-1).contiguous())
    d_dens, d_light = diff.launch_bake_adjoint(*adj, float64=True)
    variants.ds_diff_variant(0, 8, 0)
    p_dens, p_light = diff.launch_bake_adjoint(*adj, lib=variants, float64=True)
    assert _rel(d_dens, p_dens) <= 1e-12 and _rel(d_light, p_light) <= 1e-5
    dl = scene.density.clone().requires_grad_(True)
    ll = sun_n.clone().requires_grad_(True)
    out = diff.bake_inscatter_diff_plain(dl, diff._bbox(scene.density), ll,
                                         m.meta.density_multiplier, m.meta.step)
    w_dens, w_light = torch.autograd.grad(out, (dl, ll), back.baked)
    assert _rel(d_dens, w_dens) <= 1e-6 and _rel(d_light, w_light) <= 1e-5


@pytest.mark.parametrize("baked", [True, False], ids=["baked", "pointwise"])
def test_diff_card_matches_cpu(card, baked):
    _diff_close(_diff_grads(_diff_scene(card), baked, kernels=True),
                _diff_grads(_diff_scene("cpu"), baked, kernels=False))


def test_diff_bake_forward_is_k3_bitwise(card):
    from deepestscatter_tpu_torch.render import diff

    scene = _diff_scene(card)
    sun_n = scene.sun_dir / torch.linalg.norm(scene.sun_dir)
    bbox = diff._bbox(scene.density)
    before = inscatter.sun_transmittance.launches
    got = diff.bake_inscatter_diff(scene.density, bbox, sun_n, 100.0, 1.0 / 128.0, device=card)
    assert inscatter.sun_transmittance.launches == before + 1
    assert torch.equal(got, diff.bake_inscatter_diff_plain(scene.density, bbox, sun_n, 100.0,
                                                           1.0 / 128.0))


def test_diff_sun_transmittance_matches_plain(card):
    from deepestscatter_tpu_torch.render import diff

    scene = _diff_scene(card)
    pos = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (5000, 3))
                           .astype(np.float32)).to(card)
    w = torch.from_numpy(np.random.default_rng(4).random(5000).astype(np.float32)).to(card)
    out = []
    for fn in (diff.sun_transmittance, diff.sun_transmittance_plain):
        leaves = [t.clone().requires_grad_(True) for t in (scene.density, scene.sun_dir, pos)]
        kw = {"device": card} if fn is diff.sun_transmittance else {}
        t = fn(*leaves, 100.0, 64, 1.0 / 128.0, **kw)
        out.append([t.detach()] + list(torch.autograd.grad((t * w).sum(), leaves)))
    (t_k, *g_k), (t_p, *g_p) = out
    assert float((t_k - t_p).abs().max()) <= 1e-6
    for a, b in zip(g_k, g_p):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    # The samples the kernel reports taking in the box (a line crosses it once).
    to_sun = diff._to_sun(scene.sun_dir).contiguous()
    steps = torch.zeros(5000, dtype=torch.int32, device=card)
    got = diff.launch_sun_march(scene.density, to_sun, pos, 100.0, 64, 1.0 / 128.0, steps=steps)
    s = torch.tensor([diff._step_distance(1.0 / 128.0, j + 1) for j in range(64)], device=card)
    u = (pos[:, None, :] + to_sun * s[:, None]) / diff._bbox(scene.density)
    assert torch.equal(steps, ((u >= 0) & (u <= 1)).all(dim=-1).sum(dim=1).to(torch.int32))
    # Against the first design (csrc/diff_variants.cu): T and the samples
    # bitwise, the adjoint within 1e-5 of each output's largest (its runs
    # merged: its sums in another float32 order).
    variants = cuda_build.load("diff_variants")
    variants.ds_diff_forward_variant.argtypes = [ctypes.c_int] * 3
    variants.ds_diff_forward_variant(8, 0, 0)
    first_steps = torch.zeros_like(steps)
    first = diff.launch_sun_march(scene.density, to_sun, pos, 100.0, 64, 1.0 / 128.0,
                                  steps=first_steps, lib=variants)
    assert torch.equal(got, first) and torch.equal(steps, first_steps)
    bwd = (scene.density, to_sun, pos, got, w, 100.0, 64, 1.0 / 128.0)
    for a, b in zip(diff.launch_sun_march_bwd(*bwd), diff.launch_sun_march_bwd(*bwd, lib=variants)):
        assert _rel(a, b) <= 1e-5


def test_diff_wrappers_count_launches(card):
    from deepestscatter_tpu_torch.render import diff

    fns = (inscatter.sun_transmittance, diff.launch_bake_adjoint, diff.launch_march,
           diff.launch_march_bwd)
    before = [f.launches for f in fns]
    diff.render_and_grads(_diff_scene(card), device=card, **DIFF_KW)
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 1, 1]


def test_diff_gradients_repeat_within_atomic_order(card):
    """Atomics add in another order each run: the image is bitwise the
    same, the gradients within 1e-5 of their largest values."""
    scene = _diff_scene(card)
    a, b = (_diff_grads(scene, True, kernels=True) for _ in range(2))
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1:], b[1:]):
        assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max())


# -- the differentiable multi-scatter renderer: K3, K4, K8c, K8a -----------------

#: tests/test_diff_cross_validation.py's gradient point: its 16^3 thin cloud
#: at 400 m, 12 x 8, max_depth 3, 2 subframes, seed 4; the mode cases K8c
#: takes.
MS_KW = dict(width=12, height=8, max_depth=3, n_subframes=2, seed=4)
MS_CASES = {
    "all_scatter": {},
    "multiple": dict(mode=config.RenderMode.SUN_MULTIPLE_SCATTER),
    "single": dict(mode=config.RenderMode.SUN_SINGLE_SCATTER),
    "sky_roulette": dict(sample_sky=True, rr_start_depth=2, rr_survival=0.8),
}
#: Kernels against the plain versions on the card: image relative to its
#: largest value, the density gradient to its largest, the other leaves
#: each to theirs.
MS_TOL = {"image": 1e-5, "density": 1e-5, "sun_dir": 1e-4, "eye": 1e-4, "look_at": 1e-4,
          "light_radiance": 1e-4}


def _ms_scene(dev):
    from deepestscatter_tpu_torch.render import diff

    d = np.zeros((16, 16, 16), np.float32)
    d[3:-3, 3:-3, 3:-3] = np.random.default_rng(0).random((10,) * 3).astype(np.float32)
    return diff.diff_scene_from_numpy(d / d.max(), np.asarray([-0.3, -0.9, 0.1], np.float32),
                                      np.asarray([2.5, -0.4, 0.0], np.float32),
                                      np.zeros(3, np.float32), np.full(3, 1e6, np.float32),
                                      device=dev)


def _ms_cfg(case):
    return config.SceneConfig(
        cloud=config.CloudModel(size_m=400.0),
        light=config.DirectionalLight(direction=(-0.3, -0.9, 0.1)),
        rendering=config.CloudRendering(sample_step=1.0 / 64.0, **MS_CASES[case]))


def _ms_grads(scene, cfg, kernels):
    from deepestscatter_tpu_torch.render import diff

    leaves = [t.detach().clone().requires_grad_(True) for t in scene]
    render = diff.render_multi_scatter_mc if kernels else diff.render_multi_scatter_mc_plain
    kw = dict(device=scene.density.device) if kernels else {}
    img = render(diff.DiffScene(*leaves), cfg, **MS_KW, **kw)
    return [img.detach()] + list(torch.autograd.grad(img.mean(), leaves))


def _ms_close(got, want, tol):
    for name, a, b in zip(tol, got, want):
        a, b = a.double().cpu(), b.double().cpu()
        assert bool(torch.isfinite(a).all()), name
        assert float((a - b).abs().max()) <= tol[name] * float(b.abs().max()), name


@pytest.mark.parametrize("case", list(MS_CASES))
def test_ms_diff_kernels_match_plain(card, case):
    """The multi-scatter render's image and gradients through the kernels
    against the plain versions on the card; then K8c on the render's own
    paths against autograd of the plain paths for a random upstream (the
    density within 1e-5 of its largest value, the other inputs within 1e-4),
    its replay bitwise equal to K4's records."""
    from deepestscatter_tpu_torch.render import diff

    scene, cfg = _ms_scene(card), _ms_cfg(case)
    _ms_close(_ms_grads(scene, cfg, True), _ms_grads(scene, cfg, False), MS_TOL)
    with torch.no_grad():
        params, static = diff.diff_scene(cfg, scene, MS_KW["max_depth"])
        rays = diff.path_rays(scene, cfg, MS_KW["width"], MS_KW["height"], params, static)
    n, s = rays.hit.shape[0], MS_KW["n_subframes"]
    g = torch.from_numpy(np.random.default_rng(5).random((s, n, 3)).astype(np.float32)).to(card)
    g = torch.where(rays.hit[None, :, None], g, 0.0).contiguous()
    inputs = [t.detach().clone().contiguous() for t in (
        params.density_mips[0], params.inscatter, params.light_dir, params.light_radiance,
        rays.entry, rays.dirs)]
    p = diff._sample_params(inputs[0], inputs[1], params.phase)
    counters = torch.zeros(4, dtype=torch.int64, device=card)
    got = diff.launch_path_adjoint(p, static, inputs[4], inputs[5], rays.hit, rays.ids,
                                   MS_KW["seed"], 1, s, g, counters=counters)
    rec = pathtracer.launch_samples(p, static, inputs[4], inputs[5], rays.hit, rays.ids,
                                    MS_KW["seed"], 1, s)
    hit = rays.hit
    assert torch.equal(got.records.radiance[:, hit], rec.radiance[:, hit])
    assert torch.equal(got.records.work[:, hit], rec.work[:, hit])
    # The sweep's work list: every hit sample that marched (g is nonzero on
    # each), all taken by the sweep's groups.
    head, front, taken, back = counters.tolist()
    assert front + back == int((rec.work[:, hit, 0] > 0).sum()) > 0
    assert taken >= front + back and head >= s * n
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    pl = params._replace(density_mips=(leaves[0],), inscatter=leaves[1], light_dir=leaves[2],
                         light_radiance=leaves[3])
    ref = diff.path_records_plain(pl, static, leaves[4], leaves[5], hit, rays.ids,
                                  MS_KW["seed"], s)
    want = torch.autograd.grad(ref, leaves, g)
    for name, w in zip(("density", "inscatter", "light_dir", "light_radiance", "entry", "dirs"),
                       want):
        assert float(w.abs().max()) > 0, name
        assert _rel(getattr(got, name), w) <= (1e-5 if name == "density" else 1e-4), name


def test_ms_diff_card_matches_cpu(card):
    """The kernels on the card against the plain versions on the CPU, at
    the single-scatter card-against-CPU tolerances (DIFF_TOL); K8c's two
    kernels on the card against autograd of the plain paths on the CPU for
    a random upstream, at the same tolerances (the density 1e-4, the other
    inputs 1e-3 of their largest values)."""
    from deepestscatter_tpu_torch.render import diff

    cfg = _ms_cfg("all_scatter")
    _ms_close(_ms_grads(_ms_scene(card), cfg, True), _ms_grads(_ms_scene("cpu"), cfg, False),
              DIFF_TOL)
    scene = _ms_scene(card)
    with torch.no_grad():
        params, static = diff.diff_scene(cfg, scene, MS_KW["max_depth"])
        rays = diff.path_rays(scene, cfg, MS_KW["width"], MS_KW["height"], params, static)
    n, s = rays.hit.shape[0], MS_KW["n_subframes"]
    g = torch.from_numpy(np.random.default_rng(6).random((s, n, 3)).astype(np.float32)).to(card)
    g = torch.where(rays.hit[None, :, None], g, 0.0).contiguous()
    inputs = [t.detach().clone().contiguous() for t in (
        params.density_mips[0], params.inscatter, params.light_dir, params.light_radiance,
        rays.entry, rays.dirs)]
    got = diff.launch_path_adjoint(diff._sample_params(inputs[0], inputs[1], params.phase), static,
                                   inputs[4], inputs[5], rays.hit, rays.ids, MS_KW["seed"], 1, s,
                                   g)
    leaves = [t.cpu().requires_grad_(True) for t in inputs]
    pl = params_to(params, "cpu")._replace(density_mips=(leaves[0],), inscatter=leaves[1],
                                           light_dir=leaves[2], light_radiance=leaves[3])
    ref = diff.path_records_plain(pl, static, leaves[4], leaves[5], rays.hit.cpu(),
                                  rays.ids.cpu(), MS_KW["seed"], s)
    want = torch.autograd.grad(ref, leaves, g.cpu())
    for name, w in zip(("density", "inscatter", "light_dir", "light_radiance", "entry", "dirs"),
                       want):
        assert float(w.abs().max()) > 0, name
        assert _rel(getattr(got, name).cpu(), w) <= (1e-4 if name == "density" else 1e-3), name


@pytest.mark.parametrize("point", ["small", "frame"])
def test_ms_diff_k8c_equals_its_first_design(card, point):
    """K8c's two kernels (the replay on K4's queue, the sweep with G lanes a
    sample) against its first design (a thread a (sample, pixel),
    ``csrc/path_adjoint_variants.cu``) on the same inputs: the replayed
    records bitwise equal (and equal to K4's where the pixels hit), the
    density gradient within 1e-5 of its largest value, every other output
    within 1e-4; at the small point for a random upstream, at the
    multi-scatter frame point (chip_smoke.py's: 262,144 paths) for the
    image mean's."""
    from deepestscatter_tpu_torch.probes import march_variants as mv
    from deepestscatter_tpu_torch.render import diff

    if point == "frame":
        args, g = mv.ms_frame_inputs(diff, card)
    else:
        cfg, scene = _ms_cfg("sky_roulette"), _ms_scene(card)
        with torch.no_grad():
            params, static = diff.diff_scene(cfg, scene, MS_KW["max_depth"])
            rays = diff.path_rays(scene, cfg, MS_KW["width"], MS_KW["height"], params, static)
        n, s = rays.hit.shape[0], MS_KW["n_subframes"]
        args = (diff._sample_params(params.density_mips[0].contiguous(),
                                    params.inscatter.contiguous(), params.phase),
                static, rays.entry.contiguous(), rays.dirs.contiguous(), rays.hit, rays.ids,
                MS_KW["seed"], 1, s)
        g = torch.from_numpy(np.random.default_rng(7).random((s, n, 3)).astype(np.float32))
        g = torch.where(rays.hit[None, :, None], g.to(card), 0.0).contiguous()
    lib = mv.path_lib(cuda_build.load("path_adjoint_variants"))
    new = diff.launch_path_adjoint(*args, g)
    first = mv.path_design(lib, args, g, mv.PATH_DESIGNS["first design (a thread an item)"])()
    check = mv.path_check(first, new, pathtracer.launch_samples(*args), args[4])
    assert check["bitwise"], check
    assert check["equal"], check


def test_ms_diff_wrappers_count_launches(card, monkeypatch):
    from deepestscatter_tpu_torch.render import diff

    # The main path's K8c keeps its counters here: the backward pass calls
    # the module's launch_path_adjoint, whose launches count this wrapper.
    k8c, counters = diff.launch_path_adjoint, torch.zeros(4, dtype=torch.int64, device=card)

    def k8c_counted(*args, **kw):
        return k8c(*args, counters=counters, **kw)

    k8c_counted.launches = 0
    monkeypatch.setattr(diff, "launch_path_adjoint", k8c_counted)
    fns = (inscatter.sun_transmittance, pathtracer.scatter_loop, k8c_counted,
           diff.launch_bake_adjoint)
    before = [f.launches for f in fns]
    diff.multi_scatter_and_grads(_ms_scene(card), _ms_cfg("all_scatter"), device=card, **MS_KW)
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 1, 1]
    # K8c's launch ran both kernels: the replay took every item, the sweep
    # every work-list entry (the image mean's upstream reaches every hit
    # sample).
    head, front, taken, back = counters.tolist()
    assert head >= MS_KW["n_subframes"] * MS_KW["width"] * MS_KW["height"]
    assert 0 < front + back <= taken


# -- K9 (the slab march) and K3's plane range ---------------------------------


def _k9_rig(scene, card, mode, device=None):
    """The 48^3 scene at max_depth 40 in ``mode``, baked, on ``device``
    (default the card), and its camera's rays."""
    cfg, params, static = scene
    params = with_baked_inscatter(params, static, device=card)
    static = dataclasses.replace(static, mode=mode, max_depth=40)
    if device is not None:
        params = params_to(params, device)
    dev = params.bbox_size.device
    o, d = camera.generate_rays(camera.camera_basis(cfg.camera), cfg.camera.width,
                                cfg.camera.height, dev)
    hit, t_hit = camera.intersect_box(o, d, static, params.bbox_size)
    entry = camera.entry_points(o, d, t_hit, params.bbox_size)
    return params, static, (entry, d, hit, torch.arange(o.shape[0], device=dev))


def _k9_subframe(params, static, rays, n_slabs, phase_fn, check=None):
    """One subframe on ``n_slabs`` slabs in this process, ``phase_fn`` a
    slab a phase (``check(scene, rec, out)`` after each) → radiance."""
    from deepestscatter_tpu_torch.parallel import spatial_render as sr
    from deepestscatter_tpu_torch.ops import rng as rng_ops

    entry, d, hit, ids = rays
    st = sr.phase_static(static)
    dev = entry.device
    scenes = [sr.slab_scene(params, i, n_slabs, device=dev) for i in range(n_slabs)]
    spp = sr.default_steps_per_phase(static, static.grid_shape[0] // n_slabs)
    seed = rng_ops.subframe_seed(5, 1)

    def phase(rec, n_alive):
        outs = [phase_fn(s, st, seed, ids, spp, rec) for s in scenes]
        for s, out in zip(scenes, outs if check else ()):
            check(s, st, seed, ids, spp, rec, out)
        return sr.merge_slabs(outs)

    rec = sr.run_phases(sr.begin_records(entry, d, hit, params.bbox_size), phase, spp,
                        static.max_total_steps)[0]
    return torch.where(hit[:, None], rec[:, sr.RAD:sr.RAD + 3], 0.0)


@pytest.mark.parametrize("mode", list(config.RenderMode))
def test_spatial_phase_kernel_matches_plain_and_k4(scene, card, mode):
    """K9 on 2 slabs: every phase's records equal the plain version's on
    the same inputs in depth, alive, touched and steps, the rest within
    1e-5 of each column's largest value (at least 1); the subframe equals
    K4's (``render_subframe``'s samples) bitwise."""
    from deepestscatter_tpu_torch.parallel import spatial_render as sr

    params, static, rays = _k9_rig(scene, card, mode)
    entry, d, hit, ids = rays

    def check(s, st, seed, ids_, spp, rec, out):
        ref = sr.spatial_phase_plain(s, st, seed, ids_, spp, rec)
        assert torch.equal(out[:, sr.DEPTH:], ref[:, sr.DEPTH:])
        scale = ref.abs().amax(dim=0).clamp(min=1.0)
        assert ((out - ref).abs() / scale).max().item() <= 1e-5

    before = sr.spatial_phase.launches
    got = _k9_subframe(params, static, rays, 2, sr.spatial_phase, check)
    assert sr.spatial_phase.launches > before
    k4 = pathtracer.scatter_loop(params, static, entry, d, hit, ids,
                                 pathtracer.rng_ops.subframe_seed(5, 1), 0, 1)
    torch.cuda.synchronize()
    assert bool(k4.steps.max() < static.max_total_steps)
    assert torch.equal(got, torch.where(hit[:, None], k4.mean, 0.0))


@pytest.mark.parametrize("mode", list(config.RenderMode))
def test_spatial_phase_designs_match_the_package(scene, card, mode):
    """Every design of ``csrc/spatial_variants.cu`` (``ds_spatial_variant``:
    the first design, a thread a ray; the package's kernel at G = 1, 4, 8,
    16 and 32 lanes a ray; launch bounds of 1 and 12 resident blocks) on 2
    slabs: every phase's records bitwise the package's K9's on the same
    inputs, and the subframe bitwise K4's (``render_subframe``'s
    samples)."""
    from deepestscatter_tpu_torch.parallel import spatial_render as sr
    from deepestscatter_tpu_torch.probes import march_variants as mv

    lib = mv.spatial_lib(cuda_build.load("spatial_variants"))
    params, static, rays = _k9_rig(scene, card, mode)
    entry, d, hit, ids = rays
    k4 = pathtracer.scatter_loop(params, static, entry, d, hit, ids,
                                 pathtracer.rng_ops.subframe_seed(5, 1), 0, 1)
    ref = torch.where(hit[:, None], k4.mean, 0.0)

    def check(s, st, seed, ids_, spp, rec, out):
        assert torch.equal(out, sr.spatial_phase(s, st, seed, ids_, spp, rec))

    for name, code in mv.SPATIAL_DESIGNS.items():
        def variant(s, st, seed, ids_, spp, rec, code=code):
            lib.ds_spatial_variant(*code)
            return sr._launch(s, st, seed, ids_, spp, rec, lib=lib)

        got = _k9_subframe(params, static, rays, 2, variant, check)
        assert torch.equal(got, ref), name


def test_spatial_phase_card_against_cpu(scene, card):
    """K9 on the card against the plain version on the CPU over a whole
    subframe on 4 slabs: K4's card-against-CPU rule (the devices' float
    functions differ in the last bit), >= 99 % of pixels within 1e-5 of
    the image's largest value."""
    from deepestscatter_tpu_torch.parallel import spatial_render as sr

    mode = config.RenderMode.SUN_AND_SKY_ALL_SCATTER
    params, static, rays = _k9_rig(scene, card, mode)
    got = _k9_subframe(params, static, rays, 4, sr.spatial_phase).cpu()
    cp, cs, crays = _k9_rig(scene, card, mode, device="cpu")
    ref = _k9_subframe(cp, cs, crays, 4, sr.spatial_phase_plain)
    close = (got - ref).abs().max(dim=1).values <= 1e-5 * ref.abs().max()
    assert close.float().mean().item() >= 0.99


def test_bake_planes_kernel_equals_the_whole_bake(scene, card):
    _, params, static = scene
    k3 = (params.density_mips[0], static.bbox, static.light_direction, static.sample_step,
          static.density_multiplier, True)
    whole = inscatter.launch_bake(*k3)
    before = inscatter.sun_transmittance.launches
    parts = torch.cat([inscatter.launch_bake(*k3, planes=p) for p in ((0, 17), (17, 18),
                                                                       (18, 48))])
    torch.cuda.synchronize()
    assert torch.equal(parts, whole) and inscatter.sun_transmittance.launches == before + 3
    with pytest.raises(ValueError):
        inscatter.launch_bake(*k3, planes=(5, 49))


# -- empty-space skipping ----------------------------------------------------


def _two_blobs() -> np.ndarray:
    """A 48^3 grid holding two 16^3 cumulus blobs in opposite corners: the
    cloud AABB spans the box, so the camera march and the sampler (which
    clip to it) cross empty occupancy blocks as well as empty cells."""
    c = procedural.cumulus(16, seed=11)
    d = np.zeros((48, 48, 48), np.float32)
    d[2:18, 4:20, 2:18] = c
    d[30:46, 28:44, 30:46] = c
    return d


@pytest.fixture(scope="module", params=["float32", "uint8"])
def skip_scene(card, request):
    """The two-blob grid at 2000 m, step 1/128 (a long step 21 lattice
    steps), its occupancy built, baked; 64 x 32 camera rays."""
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        camera=config.CameraConfig(width=64, height=32),
        rendering=config.CloudRendering(march_dtype=request.param, sample_step=1.0 / 128.0,
                                        occupancy_skipping=True))
    params, static = build_scene(cfg, _two_blobs(), device=card)
    assert static.occupancy_skip_steps == 21
    return cfg, with_baked_inscatter(params, static, device=card), static


def _skip_static(static, skip):
    """The scene's static with the cell jump alone or the block skip alone."""
    if skip == "cell":
        return dataclasses.replace(static, occupancy_skip_steps=0, march_empty_skip=True)
    return static


SKIPS = ["cell", "block"]


@pytest.mark.parametrize("skip", SKIPS)
def test_skip_pathtrace_kernel_matches_plain(skip_scene, card, skip):
    """K4's skipping instantiations against the skipping plain loop: counts
    equal, steps and lattice steps jumped equal on >= 99 % of pixels, there
    mean and m2 within K4's tolerances; the skip jumped steps."""
    cfg, params, static = skip_scene
    static = dataclasses.replace(_skip_static(static, skip), max_depth=40)
    rays = _pt_rays(cfg, params, static, card)
    got = pathtracer.scatter_loop(params, static, *rays, 5, 1, 3)
    ref = pathtracer.scatter_loop_plain(params, static, *rays, 5, 1, 3)
    torch.cuda.synchronize()
    assert torch.equal(got.count, ref.count) and int(ref.jumped.sum()) > 0
    same = (got.steps == ref.steps) & (got.jumped == ref.jumped)
    assert same.float().mean().item() >= 0.99
    for a, b, tol in ((got.mean, ref.mean, 1e-5), (got.m2, ref.m2, 1e-4)):
        assert (a - b)[same].abs().max().item() <= tol * (b.abs().max().item() + 1e-12)


@pytest.mark.parametrize("skip", SKIPS)
def test_skip_pathtrace_kernel_cap_in_lattice_steps(skip_scene, card, skip):
    """The cap counts lattice steps advanced: no sample passes 30 of them,
    and kernel and plain loop agree on every pixel."""
    cfg, params, static = skip_scene
    static = _skip_static(static, skip)
    rays = _pt_rays(cfg, params, static, card)
    got = pathtracer.scatter_loop(params, static, *rays, 5, 1, 2, max_steps=30)
    ref = pathtracer.scatter_loop_plain(params, static, *rays, 5, 1, 2, max_steps=30)
    assert int((got.steps + got.jumped).max()) <= 60
    assert torch.equal(got.steps, ref.steps) and torch.equal(got.jumped, ref.jumped)


def test_skip_radiance_kernel_matches_plain(skip_scene, card):
    """K7b with the cell jump: counts, steps, scatters and jumps equal per
    lane; the moments within K4's tolerances; its collector static drops
    the block skip."""
    _, params, static = skip_scene
    rs = dataclasses.replace(collectors.radiance_static(_skip_static(static, "cell")),
                             max_depth=200)
    assert collectors.radiance_static(static).occupancy_skip_steps == 0
    entry, d, rids, base = _radiance_case(params, static, card)
    o, dd, ids, sub0 = collectors._lanes(entry, d, rids, base, 3, 4)
    hit = torch.ones(o.shape[0], dtype=torch.bool, device=card)
    got, _ = collectors.launch_radiance(params, rs, o, dd, ids, sub0, 9, 4)
    ref = pathtracer.scatter_loop_plain(params, rs, o, dd, hit, ids, 9, sub0, 4)
    torch.cuda.synchronize()
    assert int(ref.jumped.sum()) > 0
    for name in ("count", "steps", "bounces", "jumped"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    for a, b, tol in ((got.mean, ref.mean, 1e-5), (got.m2, ref.m2, 1e-4)):
        assert (a - b).abs().max().item() <= tol * (b.abs().max().item() + 1e-12)


@pytest.mark.parametrize("skip", SKIPS)
def test_skip_samples_kernel_matches_plain(skip_scene, card, skip):
    """K7a with each skip bitwise its plain version, with fewer steps than
    without it."""
    _, params, static = skip_scene
    st = _skip_static(static, skip)
    got = collectors._launch_samples(params, st, 777, 3)
    ref = collectors.generate_scatter_samples_plain(params, st, 777, 3)
    plain = collectors._launch_samples(
        params, dataclasses.replace(st, occupancy_skip_steps=0, march_empty_skip=False), 777, 3)
    torch.cuda.synchronize()
    for name, a, b in zip(ref._fields, got, ref):
        assert torch.equal(a, b), name
    assert int(got.steps.sum()) < int(plain.steps.sum())


def test_skip_march_kernel_matches_plain(skip_scene, card):
    """K1 with the block skip, both passes, at the plain version's
    tolerances; the long steps cut the steps taken."""
    cfg, params, static = skip_scene
    entry, dirs, ids = _camera_rays(cfg, params, static, card)
    _march_matches_plain(params, static, entry, dirs, ids)
    no_skip = dataclasses.replace(static, occupancy_skip_steps=0)
    march.camera_march(params, no_skip, entry, dirs)
    plain_steps = int(march.camera_march.last_counters[1])
    march.camera_march(params, static, entry, dirs)
    assert int(march.camera_march.last_counters[1]) < plain_steps


@pytest.mark.parametrize("skip", SKIPS)
def test_skip_k4_card_matches_cpu(skip_scene, card, skip):
    cfg, params, static = skip_scene
    static = dataclasses.replace(_skip_static(static, skip), max_depth=10)
    entry, d, hit, ids = _pt_rays(cfg, params, static, card)
    got = pathtracer.scatter_loop(params, static, entry, d, hit, ids, 5, 1, 2)
    ref = pathtracer.scatter_loop_plain(params_to(params, "cpu"), static,
                                        *_cpu(entry, d, hit, ids), 5, 1, 2)
    assert torch.equal(got.count.cpu(), ref.count)
    same = (got.steps.cpu() == ref.steps) & (got.jumped.cpu() == ref.jumped)
    assert same.float().mean().item() >= 0.99
    for a, b, tol in ((got.mean.cpu(), ref.mean, 1e-5), (got.m2.cpu(), ref.m2, 1e-4)):
        assert (a - b)[same].abs().max().item() <= tol * (b.abs().max().item() + 1e-12)


@pytest.mark.parametrize("skip", SKIPS)
def test_skip_k7a_card_matches_cpu(skip_scene, card, skip):
    _, params, static = skip_scene
    st = _skip_static(static, skip)
    got = collectors.generate_scatter_samples(params, st, 512, 4)
    ref = collectors.generate_scatter_samples_plain(params_to(params, "cpu"), st, 512, 4)
    found = got.found.cpu()
    assert (found == ref.found).float().mean().item() >= 0.995
    same = (got.attempts.cpu() == ref.attempts) & found & ref.found
    assert same.float().mean().item() >= 0.99 * found.float().mean().item()
    assert (got.positions.cpu() - ref.positions)[same].abs().max().item() <= 1e-4


def test_skip_k1_card_matches_cpu(skip_scene, card):
    cfg, params, static = skip_scene
    entry, dirs, ids = _camera_rays(cfg, params, static, card)
    t1 = march.camera_march(params, static, entry, dirs).transmittance.cpu()
    cpu = params_to(params, "cpu")
    r1 = march.camera_march_plain(cpu, static, *_cpu(entry, dirs)).transmittance
    assert (t1 - r1).abs().max().item() <= 1e-5
    k2 = march.camera_march(params, static, entry, dirs, 7, ids, r1.to(card))
    p2 = march.camera_march_plain(cpu, static, *_cpu(entry, dirs), 7, ids.cpu(), r1)
    ok = k2.ok.cpu()
    assert (ok == p2.ok).float().mean().item() >= 0.995
    both = ok & p2.ok
    close = (k2.scatter_pos.cpu() - p2.scatter_pos)[both].abs().max(dim=1).values <= 1e-4
    assert close.float().mean().item() >= 0.995


def test_skip_k7b_card_matches_cpu(skip_scene, card):
    _, params, static = skip_scene
    rs = dataclasses.replace(collectors.radiance_static(_skip_static(static, "cell")),
                             max_depth=50)
    entry, d, rids, base = _radiance_case(params, static, card, n=48)
    got = collectors.radiance_moments(params, rs, entry, d, rids, base, 9, 2, 3)
    ref = collectors.radiance_moments_plain(params_to(params, "cpu"), rs,
                                            *_cpu(entry, d, rids, base), 9, 2, 3)
    assert torch.equal(got[0].cpu(), ref[0])
    for a, b, tol in ((got[1].cpu(), ref[1], 1e-5), (got[2].cpu(), ref[2], 1e-4)):
        assert (a - b).abs().max().item() <= tol * (b.abs().max().item() + 1e-12)


def test_skip_wrappers_raise_without_the_occupancy(skip_scene, card):
    """A block skip requested on a scene without its occupancy grid raises:
    no wrapper falls back to marching without it."""
    cfg, params, static = skip_scene
    bare = params._replace(occupancy=torch.zeros((0, 0, 0), device=card))
    entry, dirs, ids = _camera_rays(cfg, params, static, card)
    with pytest.raises(ValueError):
        march.camera_march(bare, static, entry, dirs)
    with pytest.raises(ValueError):
        collectors.generate_scatter_samples(bare, static, 8, 1)
    with pytest.raises(ValueError):
        pathtracer.scatter_loop(bare, static, *_pt_rays(cfg, params, static, card), 5, 1, 1)


# -- the cell jump's designs (csrc/pathtrace_variants.cu) ----------------------

#: ``ds_jump_variant``'s designs that take the package's jumps: the first (a
#: jump ends its chunk), the jump inside the chunk with divided exits, the
#: first counting its jumps, the package's with every axis reading the
#: face table.
JUMP_SAME = {"first": 0, "in-chunk divided": 3, "first counted": 4, "face table": 5}


def _jump_lib():
    from deepestscatter_tpu_torch.probes import march_variants
    return march_variants.jump_lib(cuda_build.load("pathtrace_variants"))


def _k4_jump(lib, design, params, st, rays, cap=None, skip=march.SKIP_CELL):
    lib.ds_jump_variant(design)
    try:
        return pathtracer.launch_entry(lib, "ds_pathtrace", pathtracer._ARGTYPES, 1, params, st,
                                       *rays, 5, 3, cap, skip)
    finally:
        lib.ds_jump_variant(1)


def _all_equal(a, b, skip=(), rows=None):
    """Bitwise, but the fields in ``skip``; records ([samples, N, ...]) only
    on the pixels ``rows`` (a box hit: the others are left unwritten)."""
    for name, x, y in zip(a._fields, a, b):
        if name not in skip:
            if rows is not None:
                x, y = x[:, rows], y[:, rows]
            assert torch.equal(x, y), name


@pytest.mark.parametrize("design", list(JUMP_SAME))
def test_jump_pathtrace_designs_equal_package(skip_scene, card, design):
    """K4's cell jump in the designs of JUMP_SAME against the package's
    kernel (the jump inside the chunk, the exit from the face table):
    records and folds bitwise, jumps included, also with a cap of 30
    lattice steps a sample; the counted design counts jumps."""
    cfg, params, static = skip_scene
    st = _skip_static(static, "cell")
    rays = _pt_rays(cfg, params, st, card)
    lib = _jump_lib()
    for cap in (None, 30):
        ref_pm, ref_rec, _ = _k4_jump(lib, 1, params, st, rays, cap)
        pm, rec, _ = _k4_jump(lib, JUMP_SAME[design], params, st, rays, cap)
        torch.cuda.synchronize()
        assert int(ref_pm.jumped.sum()) > 0
        _all_equal(pm, ref_pm)
        _all_equal(rec, ref_rec, rows=rays[2])
    if design == "first counted":
        assert 0 < int(lib.ds_jump_count()) <= int(pm.jumped.sum())


def test_jump_probe_equals_the_kernel_without_a_skip(skip_scene, card):
    """The probe (the first design's exits taken and discarded) marches as
    the kernel without a skip: records and folds bitwise, jumped aside."""
    cfg, params, static = skip_scene
    st = _skip_static(static, "cell")
    rays = _pt_rays(cfg, params, st, card)
    lib = _jump_lib()
    pm, rec, _ = _k4_jump(lib, 2, params, st, rays)
    default = dataclasses.replace(st, march_empty_skip=False)
    ref_pm, ref_rec, _ = pathtracer.launch_entry(None, "ds_pathtrace", pathtracer._ARGTYPES, 1,
                                                 params, default, *rays, 5, 3, None)
    torch.cuda.synchronize()
    assert int(pm.jumped.sum()) > 0
    _all_equal(pm, ref_pm, ("jumped",))
    _all_equal(rec, ref_rec, rows=rays[2])


@pytest.fixture(scope="module")
def jump_scene_64(card):
    """The two blobs in a 64^3 grid (a power of two on every axis: the
    package's faces by product), uint8, at 2000 m, baked; 64 x 32 rays."""
    d = np.zeros((64, 64, 64), np.float32)
    d[8:56, 8:56, 8:56] = _two_blobs()
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        camera=config.CameraConfig(width=64, height=32),
        rendering=config.CloudRendering(march_dtype="uint8"))
    params, static = build_scene(cfg, d, device=card)
    return cfg, with_baked_inscatter(params, static, device=card), static


@pytest.mark.parametrize("grid", ["48^3", "64^3"])
def test_jump_pathtrace_fine_step_matches_first_design_and_plain(skip_scene, jump_scene_64, card,
                                                                 grid):
    """At a step of 1/512 (a cell of 48^3 spans 10.7 steps and one of 64^3
    8, so a chunk takes several jumps; 64^3 takes the faces by product,
    48^3 from the table) the package's K4 equals the first design bitwise
    and the plain twin at K4's tolerances (steps and jumps on >= 99 % of
    pixels, there mean within 1e-5 and m2 within 1e-4 of their largest)."""
    cfg, params, static = skip_scene if grid == "48^3" else jump_scene_64
    st = dataclasses.replace(_skip_static(static, "cell"), sample_step=1.0 / 512.0, max_depth=40)
    rays = _pt_rays(cfg, params, st, card)
    lib = _jump_lib()
    got, rec, _ = _k4_jump(lib, 1, params, st, rays)
    first, first_rec, _ = _k4_jump(lib, 0, params, st, rays)
    ref = pathtracer.scatter_loop_plain(params, st, *rays, 5, 1, 3)
    torch.cuda.synchronize()
    _all_equal(first, got)
    _all_equal(first_rec, rec, rows=rays[2])
    assert torch.equal(got.count, ref.count) and int(ref.jumped.sum()) > 0
    same = (got.steps == ref.steps) & (got.jumped == ref.jumped)
    assert same.float().mean().item() >= 0.99
    for a, b, tol in ((got.mean, ref.mean, 1e-5), (got.m2, ref.m2, 1e-4)):
        assert (a - b)[same].abs().max().item() <= tol * (b.abs().max().item() + 1e-12)


@pytest.mark.parametrize("design", list(JUMP_SAME))
def test_jump_radiance_designs_equal_package(skip_scene, card, design):
    """K7b's cell jump in the designs of JUMP_SAME against the package's
    warp of deferred scatters: records and folds bitwise, jumps included."""
    _, params, static = skip_scene
    rs = dataclasses.replace(collectors.radiance_static(_skip_static(static, "cell")),
                             max_depth=200)
    entry, d, rids, base = _radiance_case(params, static, card)
    lanes = collectors._lanes(entry, d, rids, base, 3, 4)
    lib = _jump_lib()
    ref = collectors.launch_radiance(params, rs, *lanes, 9, 4, lib=lib)
    lib.ds_jump_variant(JUMP_SAME[design])
    try:
        got = collectors.launch_radiance(params, rs, *lanes, 9, 4, lib=lib)
    finally:
        lib.ds_jump_variant(1)
    torch.cuda.synchronize()
    assert int(ref[0].jumped.sum()) > 0
    _all_equal(got[0], ref[0])
    _all_equal(got[1], ref[1])


# -- K4's block skip and K7a's cell jump redesigned -----------------------------

def _block_lib():
    from deepestscatter_tpu_torch.probes import march_variants
    return march_variants.block_lib(cuda_build.load("pathtrace_variants"))


def _k4_block(lib, design, params, st, rays, cap=None):
    lib.ds_block_variant(design)
    try:
        return pathtracer.launch_entry(lib, "ds_pathtrace", pathtracer._ARGTYPES, 1, params, st,
                                       *rays, 5, 3, cap, march.SKIP_BLOCK)
    finally:
        lib.ds_block_variant(1)


def test_block_pathtrace_first_design_equals_package(skip_scene, card):
    """K4's block skip in its first design (``ds_block_variant(0)``: the
    float32 occupancy read at every step) against the package's kernel (the
    density certificate, the bits): records and folds bitwise, jumps
    included, also with a cap of 30 lattice steps a sample."""
    cfg, params, static = skip_scene
    assert march.block_sure_steps(static) == 16
    rays = _pt_rays(cfg, params, static, card)
    lib = _block_lib()
    for cap in (None, 30):
        ref_pm, ref_rec, _ = _k4_block(lib, 1, params, static, rays, cap)
        pm, rec, _ = _k4_block(lib, 0, params, static, rays, cap)
        torch.cuda.synchronize()
        assert int(ref_pm.jumped.sum()) > 0
        _all_equal(pm, ref_pm)
        _all_equal(rec, ref_rec, rows=rays[2])


@pytest.fixture(scope="module")
def block_scene_64(card):
    """The two blobs in a 64^3 grid at step 1/512 with the occupancy built
    (long steps of 64 lattice steps, 48 certified), uint8, baked; 64 x 32
    rays."""
    d = np.zeros((64, 64, 64), np.float32)
    d[8:56, 8:56, 8:56] = _two_blobs()
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        camera=config.CameraConfig(width=64, height=32),
        rendering=config.CloudRendering(march_dtype="uint8", sample_step=1.0 / 512.0,
                                        occupancy_skipping=True, max_depth=40))
    params, static = build_scene(cfg, d, device=card)
    assert (static.occupancy_skip_steps, march.block_sure_steps(static)) == (64, 48)
    return cfg, with_baked_inscatter(params, static, device=card), static


def test_block_pathtrace_fine_step_matches_first_design_and_plain(block_scene_64, card):
    """At step 1/512 on 64^3 (48 certified steps) the package's block skip
    equals its first design bitwise and the plain twin at K4's tolerances
    (steps and jumps on >= 99 % of pixels, there mean within 1e-5 and m2
    within 1e-4 of their largest)."""
    cfg, params, st = block_scene_64
    rays = _pt_rays(cfg, params, st, card)
    lib = _block_lib()
    got, rec, _ = _k4_block(lib, 1, params, st, rays)
    first, first_rec, _ = _k4_block(lib, 0, params, st, rays)
    ref = pathtracer.scatter_loop_plain(params, st, *rays, 5, 1, 3)
    torch.cuda.synchronize()
    _all_equal(first, got)
    _all_equal(first_rec, rec, rows=rays[2])
    assert torch.equal(got.count, ref.count) and int(ref.jumped.sum()) > 0
    same = (got.steps == ref.steps) & (got.jumped == ref.jumped)
    assert same.float().mean().item() >= 0.99
    for a, b, tol in ((got.mean, ref.mean, 1e-5), (got.m2, ref.m2, 1e-4)):
        assert (a - b)[same].abs().max().item() <= tol * (b.abs().max().item() + 1e-12)


def _cell_samples_lib():
    from deepestscatter_tpu_torch.probes import march_variants
    return march_variants.cell_samples_lib(cuda_build.load("march_variants"))


def test_cell_samples_first_design_equals_package(skip_scene, card):
    """K7a's cell jump in its first design (``ds_cell_samples_variant(0)``:
    rounds of 8 warps, a jump ending a chunk of 32 lanes) equals the
    package's (a thread an attempt, the exit from the face table of the
    48^3 grid) bitwise on every field, and the plain version."""
    _, params, static = skip_scene
    st = _skip_static(static, "cell")
    lib = _cell_samples_lib()
    ref = collectors._launch_samples(params, st, 777, 3)
    lib.ds_cell_samples_variant(0)
    try:
        got = collectors._launch_samples(params, st, 777, 3, lib=lib)
    finally:
        lib.ds_cell_samples_variant(1)
    plain = collectors.generate_scatter_samples_plain(params, st, 777, 3)
    torch.cuda.synchronize()
    for name, a, b, c in zip(ref._fields, got, ref, plain):
        assert torch.equal(a, b) and torch.equal(b, c), name


def test_cell_samples_product_faces_match_plain(jump_scene_64, card):
    """On a 64^3 grid (the faces by product, kSkipCellPow2) K7a's cell jump
    equals its first design and its plain version bitwise on every field,
    at step 1/128 and 1/512."""
    _, params, static = jump_scene_64
    lib = _cell_samples_lib()
    for step in (1.0 / 128.0, 1.0 / 512.0):
        st = dataclasses.replace(static, march_empty_skip=True, sample_step=step)
        got = collectors._launch_samples(params, st, 512, 7)
        lib.ds_cell_samples_variant(0)
        try:
            first = collectors._launch_samples(params, st, 512, 7, lib=lib)
        finally:
            lib.ds_cell_samples_variant(1)
        ref = collectors.generate_scatter_samples_plain(params, st, 512, 7)
        torch.cuda.synchronize()
        for name, a, b, c in zip(ref._fields, got, first, ref):
            assert torch.equal(a, b) and torch.equal(a, c), name
