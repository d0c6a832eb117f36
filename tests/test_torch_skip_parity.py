"""Parity of the port's empty-space skips with the JAX package on the CPU.

The occupancy-block skip (``CloudRendering.occupancy_skipping``) and the
empty-cell exit jump (``SceneStatic.march_empty_skip``), path by path as
the JAX package takes them: the path tracer's tick with the jump
(``_scatter_loop_deferred``) and its oracle loop with the block skip
(``march_deferred=False``), single scatter with either
(``next_scattering_event``), the first-scatter sampler with either, the
radiance experiments with the jump, the neural camera march with the block
skip (its pipelined march).  Inputs come from numpy seeds; the scene is a
48^3 grid holding two 16^3 cumulus blobs in opposite corners (the cloud's
AABB spans the box, so the AABB-clipped marches cross empty blocks too) at
2000 m, uint8 textures, step 1/64 (a long step is 10 lattice steps), 32 x
16 camera rays.  Stated tolerances:

- bitwise: ``build_occupancy``, ``sample_occupancy`` (points inside and
  outside the grid), the scene's occupancy and long-step count,
  ``empty_cell_exit_steps`` (random cells and points, axis-parallel and
  near-axis directions, a non-cubic grid), the empty-cell test on a zero
  cloud; with both skips off every output of the plain paths equals the
  default scene's;
- the sampler: found flags equal on >= 99.5 % of samples, directions within
  1e-6 on >= 95 % of those both found, positions there within 1e-4 (the
  existing sampler parity: JAX-CPU and torch round ``sin``/``cos``
  differently, and the port clips the march to the cloud AABB on the same
  step lattice);
- the camera march: T within rtol 1e-5, scatter flags equal on >= 99.5 %
  of rays, positions within 1e-4 where both scatter (the existing K1
  parity), on camera rays and axis-parallel rays;
- the tick and single scatter: statistical, as ``test_sharded_tick_matches_
  jax``: each pixel's largest relative difference of the mean within 1e-4
  on >= 90 % of pixels, the image means within 1e-3.  The JAX package jumps
  after an iteration of up to ``march_substeps`` steps in a cell, the port
  after each step in an empty cell: both land on the same lattice index
  up to the ulp of the jump's product, so paths agree until an ulp moves a
  crossing;
- the radiance labels: the existing criterion (the 95 % intervals overlap,
  >= 90 % of labels within 1e-3 of JAX's).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepestscatter_tpu import scene as jscene
from deepestscatter_tpu.config import (CameraConfig, CloudModel, CloudRendering,
                                       PointRadianceConfig, RenderMode, SceneConfig)
from deepestscatter_tpu.data import collectors as jcol
from deepestscatter_tpu.ops import grid as jgrid
from deepestscatter_tpu.ops import march as jmarch
from deepestscatter_tpu.render import camera as jcam
from deepestscatter_tpu.render import inscatter as jins
from deepestscatter_tpu.render import neural as jneural
from deepestscatter_tpu.render import pathtracer as jpt
from deepestscatter_tpu_torch import config as tconfig
from deepestscatter_tpu_torch import scene as tscene
from deepestscatter_tpu_torch.data import collectors as tcol
from deepestscatter_tpu_torch.data import procedural
from deepestscatter_tpu_torch.ops import grid as tgrid
from deepestscatter_tpu_torch.ops import march as tmarch
from deepestscatter_tpu_torch.render import camera as tcam
from deepestscatter_tpu_torch.render import inscatter as tins
from deepestscatter_tpu_torch.render import neural as tneural
from deepestscatter_tpu_torch.render import pathtracer as tpt

W, H = 32, 16
SEED = 7
N_SAMPLES = 96
STEP = 1.0 / 64.0


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def two_blobs() -> np.ndarray:
    c = procedural.cumulus(16, seed=11)
    d = np.zeros((48, 48, 48), np.float32)
    d[2:18, 4:20, 2:18] = c
    d[30:46, 28:44, 30:46] = c
    return d


DENSITIES = {
    "two_blobs": two_blobs,
    "cumulus": lambda: procedural.cumulus(24, seed=3),
    "zero": lambda: np.zeros((20, 28, 36), np.float32),
}


def _cfgs(occupancy, max_depth=20, mode=None):
    kw = dict(march_dtype="uint8", sample_step=STEP, max_depth=max_depth,
              occupancy_skipping=occupancy)
    if mode is not None:
        kw["mode"] = mode
    jcfg = SceneConfig(cloud=CloudModel(size_m=2000.0), camera=CameraConfig(width=W, height=H),
                       rendering=CloudRendering(**kw))
    if mode is not None:
        kw["mode"] = tconfig.RenderMode(mode.value)
    tcfg = tconfig.SceneConfig(cloud=tconfig.CloudModel(size_m=2000.0),
                               camera=tconfig.CameraConfig(width=W, height=H),
                               rendering=tconfig.CloudRendering(**kw))
    return jcfg, tcfg


class Rig:
    """The two-blob scene in both frameworks with each skip: ``skip`` is
    "cell" (the jump alone), "block" (the block skip alone) or "none"."""

    def __init__(self):
        self.density = two_blobs()
        self._scenes = {}

    def scenes(self, skip, max_depth=20, mode=None):
        key = (skip, max_depth, mode)
        if key not in self._scenes:
            jcfg, tcfg = _cfgs(skip == "block", max_depth, mode)
            jp, js = jscene.build_scene(jcfg, self.density)
            tp, ts = tscene.build_scene(tcfg, self.density, device="cpu")
            jp = jins.with_baked_inscatter(jp, js)
            tp = tins.with_baked_inscatter(tp, ts, device="cpu")
            js = dataclasses.replace(js, march_empty_skip=skip == "cell")
            ts = dataclasses.replace(ts, march_empty_skip=skip == "cell")
            self._scenes[key] = (jcfg, tcfg, (jp, js), (tp, ts))
        return self._scenes[key]

    def unskipped_samples(self):
        """The port's sampler without a skip (its steps, the skips' yardstick)."""
        if "samples" not in self._scenes:
            _, _, _, (tp, ts) = self.scenes("none")
            self._scenes["samples"] = tcol.generate_scatter_samples_plain(tp, ts, N_SAMPLES, 2)
        return self._scenes["samples"]


@pytest.fixture(scope="module")
def rig():
    return Rig()


@pytest.mark.parametrize("kind", list(DENSITIES))
def test_occupancy_bitwise(kind):
    density = DENSITIES[kind]()
    occ = tgrid.build_occupancy(density, 8)
    ref = jgrid.build_occupancy(density, 8)
    assert occ.dtype == ref.dtype and np.array_equal(occ, ref)
    u = np.random.default_rng(1).uniform(-0.3, 1.3, (4000, 3)).astype(np.float32)
    got = tgrid.sample_occupancy(torch.as_tensor(occ), torch.as_tensor(u), density.shape, 8)
    exp = jgrid.sample_occupancy(jnp.asarray(ref), jnp.asarray(u), density.shape, 8)
    assert np.array_equal(got.numpy(), np.asarray(exp))
    jcfg, tcfg = _cfgs(True)
    jp, js = jscene.build_scene(jcfg, density)
    tp, ts = tscene.build_scene(tcfg, density, device="cpu")
    assert ts.occupancy_skip_steps == js.occupancy_skip_steps
    assert ts.occupancy_block == js.occupancy_block == 8
    assert np.array_equal(tp.occupancy.numpy(), np.asarray(jp.occupancy))
    if kind == "zero":
        assert occ.max() == 0.0
        u = torch.rand((500, 3), generator=torch.Generator().manual_seed(2))
        assert bool(tgrid.cell_is_empty(tp.density_mips[0], u).all())


@pytest.mark.parametrize("shape", [(48, 48, 48), (20, 28, 36)])
def test_empty_cell_exit_steps_bitwise(shape):
    rng = np.random.default_rng(3)
    nz, ny, nx = shape
    bbox = tgrid.bbox_size_from_shape(shape)
    n = 3000
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:300] = 0.0
    d[np.arange(300), rng.integers(0, 3, 300)] = rng.choice([-1.0, 1.0], 300)  # axis-parallel
    d[300:400, 0] = 1e-10  # below the 1e-9 guard
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d.astype(np.float32)
    pos = (rng.uniform(0.0, 1.0, (n, 3)) * bbox).astype(np.float32)
    dims = np.asarray([nx, ny, nz], np.float32)
    cell = np.clip(np.floor(pos / bbox * dims - 0.5), 0, dims - 1).astype(np.int32)
    cell[:200] += rng.integers(-1, 2, (200, 3)).astype(np.int32)  # points outside their cell
    for step in (STEP, 1.0 / 512.0):
        got = tmarch.empty_cell_exit_steps(torch.as_tensor(cell), torch.as_tensor(pos),
                                           torch.as_tensor(d), torch.as_tensor(dims),
                                           torch.as_tensor(bbox), step)
        ref = jmarch.empty_cell_exit_steps(jnp.asarray(cell), jnp.asarray(pos), jnp.asarray(d),
                                           jnp.asarray(dims), jnp.asarray(bbox), jnp.float32(step))
        assert np.array_equal(got.numpy(), np.asarray(ref))
        assert got.max().item() > 1.0 and got.min().item() == 0.0


def _sampler(rig, skip, port_fn=tcol.generate_scatter_samples_plain):
    _, _, (jp, js), (tp, ts) = rig.scenes(skip)
    jpos, jdir = jcol.generate_scatter_samples(jp, js, N_SAMPLES, 2)
    return np.asarray(jpos), np.asarray(jdir), port_fn(tp, ts, N_SAMPLES, 2)


@pytest.mark.parametrize("skip", ["cell", "block"])
def test_sampler_skip_matches_jax(rig, skip):
    jpos, jdir, t = _sampler(rig, skip)
    jfound = np.any(jdir != 0.0, axis=-1)
    tfound = t.found.numpy()
    assert tfound.sum() > 0.9 * len(tfound)
    assert (jfound == tfound).mean() >= 0.995
    both = jfound & tfound
    same = both & (np.abs(t.directions.numpy() - jdir).max(axis=-1) <= 1e-6)
    assert same.mean() >= 0.95 * both.mean()
    assert np.abs(t.positions.numpy() - jpos)[same].max() <= 1e-4
    assert int(t.steps.sum()) < int(rig.unskipped_samples().steps.sum())


def _camera_rays(jcfg, tcfg, jp, tp, js, ts, axis=False):
    o, d = jcam.generate_rays(jcam.camera_basis(jcfg.camera), W, H)
    to, td = tcam.generate_rays(tcam.camera_basis(tcfg.camera), W, H, "cpu")
    if axis:  # origins outside the box, one axis each way, through both blobs' rows
        rng = np.random.default_rng(5)
        n = 96
        dirs = np.zeros((n, 3), np.float32)
        ax = np.arange(n) % 3
        sign = np.where((np.arange(n) // 3) % 2 == 0, 1.0, -1.0).astype(np.float32)
        dirs[np.arange(n), ax] = sign
        orig = rng.uniform(-0.45, 0.45, (n, 3)).astype(np.float32)
        orig[np.arange(n), ax] = -2.0 * sign
        o, d = jnp.asarray(orig), jnp.asarray(dirs)
        to, td = torch.as_tensor(orig), torch.as_tensor(dirs)
    return (o, d), (to, td)


@pytest.mark.parametrize("axis", [False, True], ids=["camera", "axis_parallel"])
def test_camera_march_block_skip_matches_jax(rig, axis):
    jcfg, tcfg, (jp, js), (tp, ts) = rig.scenes("block")
    (o, d), (to, td) = _camera_rays(jcfg, tcfg, jp, tp, js, ts, axis)
    hit, t_hit = jcam.intersect_box(o, d, js, jp.bbox_size)
    entry = o + d * t_hit[:, None] + 0.5 * jp.bbox_size
    ids = jnp.arange(o.shape[0], dtype=jnp.uint32)
    ref = jneural.conditional_scatter(jp, js, entry, d, hit, jnp.uint32(SEED), ids)
    thit, tt = tcam.intersect_box(to, td, ts, tp.bbox_size)
    tentry = tcam.entry_points(to, td, tt, tp.bbox_size)
    got = tneural.conditional_scatter(tp, ts, tentry, td, thit, SEED, torch.arange(to.shape[0]))
    h = np.asarray(hit)
    np.testing.assert_allclose(got.transmittance.numpy()[h], np.asarray(ref.transmittance)[h],
                               rtol=1e-5, atol=0)
    jf, tf = np.asarray(ref.has_scattered), got.has_scattered.numpy()
    assert jf.sum() > 5 and np.mean(jf == tf) >= 0.995
    agree = jf & tf
    np.testing.assert_allclose(got.scatter_pos.numpy()[agree], np.asarray(ref.scatter_pos)[agree],
                               rtol=0, atol=1e-4)
    # The long steps cut the steps taken.
    od = torch.zeros(tentry.shape[0])
    sel = thit
    skipped = tmarch.next_scattering_event(tp, ts, od[sel], tentry[sel], td[sel],
                                           skip=tmarch.SKIP_BLOCK).steps.sum()
    full = tmarch.next_scattering_event(tp, ts, od[sel], tentry[sel], td[sel]).steps.sum()
    assert int(skipped) < int(full)


def _close_stat(got, ref, rtol=1e-4, share=0.9, mean_rtol=1e-3):
    assert got.shape == ref.shape and np.all(np.isfinite(got))
    rel = np.abs(got - ref).max(-1) / np.maximum(np.abs(ref).max(-1), 1e-3)
    assert np.mean(rel <= rtol) >= share
    assert abs(got.mean() - ref.mean()) <= mean_rtol * abs(ref.mean())


def test_tick_cell_jump_matches_jax(rig):
    """Two subframes of the progressive tick (JAX's deferred loop with its
    cell jump; the port's plain loop with the jump after each step)."""
    jcfg, tcfg, (jp, js), (tp, ts) = rig.scenes("cell")
    o, d = jcam.generate_rays(jcam.camera_basis(jcfg.camera), W, H)
    to, td = tcam.generate_rays(tcam.camera_basis(tcfg.camera), W, H, "cpu")
    jmean, _, jcnt = jpt.trace_tick_moments(jp, js, o, d, SEED, 0, 2)
    mean, _, cnt = tpt.trace_tick_moments(tp, ts, to, td, SEED, 0, 2, device="cpu")
    assert np.array_equal(cnt.numpy(), np.asarray(jcnt))
    _close_stat(mean.numpy(), np.asarray(jmean))


@pytest.mark.parametrize("skip, mode", [
    ("block", RenderMode.SUN_AND_SKY_ALL_SCATTER),
    ("block", RenderMode.SUN_SINGLE_SCATTER),
    ("cell", RenderMode.SUN_SINGLE_SCATTER),
])
def test_subframe_skip_matches_jax(rig, skip, mode):
    """A subframe through JAX's oracle loop with its block skip, or its
    single-scatter march with either skip, against the port's plain loop."""
    jcfg, tcfg, (jp, js), (tp, ts) = rig.scenes(skip, mode=mode)
    js = dataclasses.replace(js, march_deferred=False)
    o, d = jcam.generate_rays(jcam.camera_basis(jcfg.camera), W, H)
    to, td = tcam.generate_rays(tcam.camera_basis(tcfg.camera), W, H, "cpu")
    ref = np.asarray(jpt.render_subframe(jp, js, o, d, SEED, 1))
    got = tpt.render_subframe(tp, ts, to, td, SEED, 1, device="cpu").numpy()
    _close_stat(got, ref)


def test_radiance_cell_jump_matches_jax(rig):
    """The collector's labels with the cell jump, as the JAX collector's
    deferred loop takes it by default."""
    _, _, (jp, js), (tp, ts) = rig.scenes("cell", max_depth=60)
    t = tcol.generate_scatter_samples_plain(tp, ts, 64, 2)
    idx = np.nonzero(t.found.numpy())[0][:24]
    pos, d = t.positions[idx].contiguous(), t.directions[idx].contiguous()
    cfg = PointRadianceConfig(max_threads=24 * 8, launches_per_update=4, rel_tol=0.5,
                              abs_tol=1e-9, black_min_experiments=64)
    tcfg = tconfig.PointRadianceConfig(**dataclasses.asdict(cfg))
    ref = jcol.estimate_point_radiance(jp, js, jnp.asarray(pos.numpy()), jnp.asarray(d.numpy()),
                                       cfg, seed=5, max_updates=3)
    got = tcol.estimate_point_radiance(tp, ts, pos, d, tcfg, seed=5, max_updates=3)
    assert got.schedule == ref.schedule
    assert np.array_equal(got.experiments, np.asarray(ref.experiments))
    spread = np.abs(got.radiance.astype(np.float64) - np.asarray(ref.radiance, np.float64))
    assert np.all(spread <= 2.0 * got.ci95)
    assert (spread <= 1e-3 * np.abs(np.asarray(ref.radiance, np.float64))).mean() >= 0.9
    assert got.radiance.mean() > 0


def test_skips_off_bitwise_the_default(rig):
    """The default scene takes no skip, and a scene built with its
    occupancy but marched without a skip gives the default scene's outputs
    bitwise: the tick, the sampler, the camera march."""
    _, tcfg, _, (tp, ts) = rig.scenes("none")
    assert tmarch.skip_mode(ts) == tmarch.SKIP_NONE and not ts.march_empty_skip
    assert tp.occupancy.numel() == 0
    _, _, _, (bp, bs) = rig.scenes("block")
    off = dataclasses.replace(bs, occupancy_skip_steps=0)
    assert bp.occupancy.numel() > 0 and tmarch.skip_mode(off) == tmarch.SKIP_NONE
    to, td = tcam.generate_rays(tcam.camera_basis(tcfg.camera), W, H, "cpu")
    a = tpt.trace_tick_moments(tp, ts, to, td, SEED, 0, 2, device="cpu")
    b = tpt.trace_tick_moments(bp, off, to, td, SEED, 0, 2, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    sa = tcol.generate_scatter_samples_plain(tp, ts, 24, 2)
    sb = tcol.generate_scatter_samples_plain(bp, off, 24, 2)
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)
    hit, t_hit = tcam.intersect_box(to, td, ts, tp.bbox_size)
    entry = tcam.entry_points(to, td, t_hit, tp.bbox_size)
    ca = tneural.conditional_scatter(tp, ts, entry, td, hit, SEED, torch.arange(to.shape[0]))
    cb = tneural.conditional_scatter(bp, off, entry, td, hit, SEED, torch.arange(to.shape[0]))
    for x, y in zip(ca, cb):
        assert torch.equal(x, y)
    pm = tpt.scatter_loop_plain(tp, ts, entry, td, hit, torch.arange(to.shape[0]), SEED, 1, 1)
    assert int(pm.jumped.sum()) == 0
