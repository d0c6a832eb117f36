"""The empty-space skips of K4, K7b, K1 and K7a on the host.

``tests/torch_kernel_host.cpp`` (built as ``test_torch_kernel_host.py``
builds it) exports ``ds_pathtrace_skip``, ``ds_radiance_skip``,
``ds_march_skip`` and ``ds_samples_skip``: the kernels' skipping device
functions (``csrc/skip.cuh``; K4's ``march_steps_skip``, the lane chunk's
``lane_step_skip``, ``chunk_end_skip`` and ``chunk_jump``) with a chunk's
lanes emulated one after the other.  The scene: a 48^3 grid holding two
16^3 cumulus blobs in opposite corners at 2000 m, step 1/64 (a long step is
10 lattice steps), 32 x 32 pixels, ``max_depth`` 10, both texture types.

- K4 with the cell jump and with the block skip: the items traced in item
  order and shuffled, at lookahead 1 and at the kernel's lookahead, equal
  each other bitwise (records, folds and each pixel's lattice steps
  jumped); so with a cap of 27 lattice steps a sample, which no sample
  passes (steps sampled + jumped);
- K7b with the cell jump: the kernel's warp of deferred scatters equals K4's
  item loop bitwise, jumps included;
- K1 with the block skip (chunks of 1, 8 and 32 lanes, cut before the first
  lane whose step is of the other kind) and K7a with each skip (chunks of
  1, 8 and 32 lanes, cut after the first lane in an empty cell, then the
  jump; and the kernel's rounds of attempts): every chunk size equal
  bitwise, a chunk of 1 lane being the step-by-step loop;
- each against its skipping plain version at the tolerances of
  ``test_torch_kernel_host.py`` (glibc's ``expf``/``logf``/``sinf``/``cosf``
  are not torch's): K4 steps and jumps equal on >= 99 % of pixels, there the
  mean within 1e-5 and m2 within 1e-4 of their largest values; K1's T within
  1e-5, flags on >= 99.5 % of rays, positions within 1e-4 where both
  scatter; K7a's found flags on >= 99.5 % of samples, positions within 1e-4
  where the attempts agree; and each skip takes fewer steps than no skip.

Skips only where g++ is absent.
"""

import dataclasses

import numpy as np
import pytest
import torch

from deepestscatter_tpu_torch import build_scene, config, with_baked_inscatter
from deepestscatter_tpu_torch.data import collectors, procedural
from deepestscatter_tpu_torch.ops import march
from deepestscatter_tpu_torch.render import camera, pathtracer

from test_torch_kernel_host import SAMPLES, SEED, _host_stream, _torch_threads, host_lib  # noqa: F401

PIXELS = 32


def two_blobs() -> np.ndarray:
    c = procedural.cumulus(16, seed=11)
    d = np.zeros((48, 48, 48), np.float32)
    d[2:18, 4:20, 2:18] = c
    d[30:46, 28:44, 30:46] = c
    return d


@pytest.fixture(scope="module", params=["uint8", "float32"])
def skip_rig(request):
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=2000.0),
        camera=config.CameraConfig(width=PIXELS, height=PIXELS),
        rendering=config.CloudRendering(march_dtype=request.param, sample_step=1.0 / 64.0,
                                        max_depth=10, occupancy_skipping=True))
    params, static = build_scene(cfg, two_blobs(), device="cpu")
    assert static.occupancy_skip_steps == 10
    params = with_baked_inscatter(params, static, device="cpu")
    o, d = camera.generate_rays(camera.camera_basis(cfg.camera), PIXELS, PIXELS, "cpu")
    hit, t_hit = camera.intersect_box(o, d, static, params.bbox_size)
    entry = camera.entry_points(o, d, t_hit, params.bbox_size)
    return params, static, (entry, d, hit, torch.arange(o.shape[0]))


def _static(static, skip):
    if skip == "cell":
        return dataclasses.replace(static, occupancy_skip_steps=0, march_empty_skip=True)
    if skip == "none":
        return dataclasses.replace(static, occupancy_skip_steps=0)
    return static


def _pt(lib, params, static, rays, lookahead=0, order=None, max_steps=None):
    lib.host_set_pathtrace(1, lookahead, None if order is None else order.ctypes.data)
    try:
        return pathtracer._launch(params, static, *rays, SEED, 1, SAMPLES, max_steps, lib=lib)
    finally:
        lib.host_set_pathtrace(1, 0, None)


def _equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("skip", ["cell", "block"])
def test_k4_skip_items_equal_across_lookahead_and_order(host_lib, skip_rig, skip):
    params, static, rays = skip_rig
    static = _static(static, skip)
    order = np.random.default_rng(4).permutation(PIXELS * PIXELS * SAMPLES).astype(np.int64)
    for cap in (None, 27):
        ref = _pt(host_lib, params, static, rays, 1, max_steps=cap)
        assert int(ref.jumped.sum()) > 0
        for lookahead, o in ((0, None), (0, order), (1, order)):
            _equal(_pt(host_lib, params, static, rays, lookahead, o, cap), ref)
        if cap is not None:
            assert int((ref.steps + ref.jumped).max()) <= SAMPLES * cap


@pytest.mark.parametrize("skip", ["cell", "block"])
def test_k4_skip_host_matches_plain(host_lib, skip_rig, skip):
    params, static, rays = skip_rig
    st = _static(static, skip)
    got = _pt(host_lib, params, st, rays)
    ref = pathtracer.scatter_loop_plain(params, st, *rays, SEED, 1, SAMPLES)
    assert torch.equal(got.count, ref.count)
    same = (got.steps == ref.steps) & (got.jumped == ref.jumped)
    assert same.float().mean().item() >= 0.99
    for a, b, tol in ((got.mean, ref.mean, 1e-5), (got.m2, ref.m2, 1e-4)):
        assert (a - b)[same].abs().max().item() <= tol * (b.abs().max().item() + 1e-12)
    none = pathtracer.scatter_loop_plain(params, _static(static, "none"), *rays, SEED, 1, SAMPLES)
    assert int(ref.steps.sum()) < int(none.steps.sum())


def test_k7b_skip_deferred_equals_the_item_loop(host_lib, skip_rig):
    params, static, rays = skip_rig
    rs = collectors.radiance_static(_static(static, "cell"))
    entry, d, hit, _ = rays
    idx = torch.nonzero(hit).flatten()[::4]
    entry, d = entry[idx].contiguous(), d[idx].contiguous()
    n = entry.shape[0]
    ids = torch.arange(n)
    sub0 = torch.tensor([2**32 - 2, 5, 2**31 - 1, 0] * (n // 4 + 1))[:n]
    outs = []
    for mode in (0, 1):
        host_lib.host_set_radiance(mode, 0)
        try:
            outs.append(collectors.launch_radiance(params, rs, entry, d, ids, sub0, SEED,
                                                   SAMPLES, lib=host_lib))
        finally:
            host_lib.host_set_radiance(1, 0)
    (pm0, rec0), (pm1, rec1) = outs
    assert int(pm0.jumped.sum()) > 0
    _equal(pm1, pm0)
    _equal(rec1, rec0)


def _march(lib, params, static, rays, lanes):
    entry, d, hit, ids = rays
    idx = torch.nonzero(hit).flatten()
    e, dd, i = entry[idx].contiguous(), d[idx].contiguous(), ids[idx].contiguous()
    lib.host_set_march(1, lanes)
    try:
        t1 = march._launch(params, static, e, dd, 0, None, None, lib=lib).transmittance
        return t1, march._launch(params, static, e, dd, 3, i, t1, lib=lib), (e, dd, i)
    finally:
        lib.host_set_march(1, 0)


def test_k1_block_skip_lanes_equal_and_match_plain(host_lib, skip_rig):
    params, static, rays = skip_rig
    t1, m2, (e, dd, i) = _march(host_lib, params, static, rays, 1)
    for lanes in (8, 32):
        u1, n2, _ = _march(host_lib, params, static, rays, lanes)
        assert torch.equal(u1, t1)
        _equal(n2, m2)
    p1 = march.camera_march_plain(params, static, e, dd).transmittance
    assert (p1 - t1).abs().max().item() <= 1e-5
    p2 = march.camera_march_plain(params, static, e, dd, 3, i, t1)
    assert (p2.ok == m2.ok).float().mean().item() >= 0.995
    both = p2.ok & m2.ok
    assert (p2.scatter_pos - m2.scatter_pos)[both].abs().max().item() <= 1e-4
    od = torch.zeros(e.shape[0])
    skipped = march.next_scattering_event(params, static, od, e, dd, skip=march.SKIP_BLOCK)
    assert int(skipped.steps.sum()) < int(march.next_scattering_event(params, static, od, e,
                                                                       dd).steps.sum())


@pytest.mark.parametrize("skip", ["cell", "block"])
def test_k7a_skip_lanes_and_rounds_equal_and_match_plain(host_lib, skip_rig, skip):
    params, static, _ = skip_rig
    st = _static(static, skip)
    outs = []
    for mode, lanes in ((1, 1), (1, 8), (1, 32), (2, host_lib.ds_sample_warps())):
        host_lib.host_set_samples(mode, lanes)
        try:
            outs.append(collectors._launch_samples(params, st, 160, 2, lib=host_lib))
        finally:
            host_lib.host_set_samples(2, host_lib.ds_sample_warps())
    for o in outs[1:]:
        _equal(o, outs[0])
    got = outs[0]
    ref = collectors.generate_scatter_samples_plain(params, st, 160, 2)
    assert (got.found == ref.found).float().mean().item() >= 0.995
    same = (got.attempts == ref.attempts) & got.found & ref.found
    assert same.float().mean().item() >= 0.95 * got.found.float().mean().item()
    assert (got.positions - ref.positions)[same].abs().max().item() <= 1e-4
    none = collectors._launch_samples(params, _static(static, "none"), 160, 2, lib=host_lib)
    assert int(got.steps.sum()) < int(none.steps.sum())
