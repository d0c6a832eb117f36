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
