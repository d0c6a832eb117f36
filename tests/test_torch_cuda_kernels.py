"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card with ``nvcc`` (they build the kernels);
on a host without one they skip.  Run them on the card with
``python -m pytest tests/test_torch_cuda_kernels.py -q``.

Tolerances: the bake within 1e-5 (T in [0, 1]) and its uint8 texture equal
on all but 0.1 % of voxels; the march's T within 1e-5, ok flags equal on
>= 99.5 % of rays, positions within 1e-4 where they agree; the descriptor
within 1e-5; the path tracer's bounce loop (K4) with the same per-pixel
step counts on >= 99 % of pixels, and on those the mean within 1e-5 and
m2 within 1e-4 of their largest values (both kernels and plain versions
are compiled without FMA contraction, so bitwise is the goal); the gather
probe's sums exactly equal.  The tests of the redesigned K4 (item queue,
lookahead march, per-sample records) hold step and scatter counts equal on
every pixel.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deepestscatter_tpu_torch import build_scene, config, with_baked_inscatter
from deepestscatter_tpu_torch.data import procedural
from deepestscatter_tpu_torch.ops import descriptor, march
from deepestscatter_tpu_torch.probes import gather
from deepestscatter_tpu_torch.render import camera, inscatter, pathtracer


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


def test_march_kernel_matches_plain(scene, card):
    cfg, params, static = scene
    params = with_baked_inscatter(params, static, device=card)
    entry, dirs, ids = _camera_rays(cfg, params, static, card)
    k1 = march.camera_march(params, static, entry, dirs)
    p1 = march.camera_march_plain(params, static, entry, dirs)
    assert (k1.transmittance - p1.transmittance).abs().max().item() <= 1e-5
    k2 = march.camera_march(params, static, entry, dirs, 7, ids, p1.transmittance)
    p2 = march.camera_march_plain(params, static, entry, dirs, 7, ids, p1.transmittance)
    agree = k2.ok == p2.ok
    assert agree.float().mean().item() >= 0.995
    both = k2.ok & p2.ok
    assert both.sum().item() > 0
    assert (k2.scatter_pos - p2.scatter_pos)[both].abs().max().item() <= 1e-4


def test_descriptor_kernel_matches_plain(scene, card):
    _, params, static = scene
    rng = np.random.default_rng(0)
    pos = torch.as_tensor(rng.uniform(-0.05, 1.05, (512, 3)).astype(np.float32), device=card)
    view = rng.normal(size=(512, 3)).astype(np.float32)
    view = torch.as_tensor(view / np.linalg.norm(view, axis=-1, keepdims=True), device=card)
    got = descriptor.network_inputs(params, static, pos, view)
    ref = descriptor.network_inputs_plain(params, static, pos, view)
    assert got.shape == (512, 10, 226)
    assert (got - ref).abs().max().item() <= 1e-5


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
