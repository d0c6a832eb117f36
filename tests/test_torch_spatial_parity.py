"""Rendering through a z-slab-sharded grid in the PyTorch port
(``parallel.spatial_render``: K9's plain version ``spatial_phase_plain``
on the CPU) against the JAX package's ``make_spatial_subframe`` and the
port's own path tracer, on the CPU.

The scene is the JAX package's (``tests/test_spatial_render.py``): cumulus
24^3 of seed 5, 1500 m, step 1/128, ``max_depth`` 40, 32 x 16 pixels.
World 1 runs in this process over gloo; worlds 2 and 4 and a 2 x 2 ``data``
x ``space`` mesh run as processes of their own (``parallel.launch``).
Stated tolerances:

- bitwise: the port's spatial subframe against its ``render_subframe``
  (K4's plain version) in the three modes, float32 and uint8 textures;
  across 1, 2 and 4 slabs and the 2 x 2 mesh;
- against JAX's spatial subframe (which the JAX package holds to its own
  path tracer at rtol/atol 2e-4): single scatter, every pixel within 1e-5
  of the image's largest value; the bounce loops (``max_depth`` 40),
  ``test_torch_pt_parity.py``'s deep-path rule, >= 98 % of pixels within
  a relative 1e-4 and the image mean within a relative 1e-4 (JAX-CPU and
  torch round ``exp``/``log``/``sin``/``cos`` apart in the last bit, and a
  flipped crossing moves a path).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from deepestscatter_tpu import scene as jscene
from deepestscatter_tpu.config import (CameraConfig, CloudModel, CloudRendering, RenderMode,
                                       SceneConfig)
from deepestscatter_tpu.data import procedural as jproc
from deepestscatter_tpu.parallel import make_mesh as jmake_mesh
from deepestscatter_tpu.parallel.spatial_render import make_spatial_subframe as jmake
from deepestscatter_tpu.parallel.spatial_render import shard_scene as jshard
from deepestscatter_tpu.render import camera as jcam
from deepestscatter_tpu.render import inscatter as jins
from deepestscatter_tpu_torch import config as tconfig
from deepestscatter_tpu_torch.parallel import launch
from deepestscatter_tpu_torch.parallel import mesh as tmesh
from deepestscatter_tpu_torch.parallel import spatial_render as sr
from deepestscatter_tpu_torch.render import camera as tcam
from deepestscatter_tpu_torch.render import inscatter as tins
from deepestscatter_tpu_torch.render import pathtracer as tpt
from deepestscatter_tpu_torch.scene import build_scene

W, H = 32, 16
SEED, SUB = 3, 1
MODES = ("SUN_AND_SKY_ALL_SCATTER", "SUN_MULTIPLE_SCATTER", "SUN_SINGLE_SCATTER")
SHAPES = ((1, 2), (1, 4), (2, 2))


def _tcfg(mode, dt="float32"):
    return tconfig.SceneConfig(
        cloud=tconfig.CloudModel(size_m=1500.0), camera=tconfig.CameraConfig(width=W, height=H),
        rendering=tconfig.CloudRendering(sample_step=1.0 / 128.0, max_depth=40,
                                         mode=tconfig.RenderMode[mode], march_dtype=dt))


@pytest.fixture(scope="module")
def density():
    return jproc.cumulus(resolution=24, seed=5)


@pytest.fixture(scope="module")
def launched(density):
    """The 2- and 4-rank layouts rendering in the background."""
    cfg = _tcfg(MODES[0])
    with ThreadPoolExecutor(len(SHAPES)) as pool:
        yield {s: pool.submit(launch.run, "deepestscatter_tpu_torch.parallel.jobs:spatial",
                              s[0] * s[1], device="cpu", threads=1, cfg=cfg, density=density,
                              seed=SEED, subframe=SUB, mesh_shape=s) for s in SHAPES}


@pytest.fixture(scope="module")
def world1(launched):
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{launch.free_port()}",
                            world_size=1, rank=0)
    yield tmesh.make_mesh((1, 1), ("data", "space"), device_type="cpu")
    dist.destroy_process_group()


def _port(world1, density, mode, dt="float32"):
    cfg = _tcfg(mode, dt)
    tp, ts = build_scene(cfg, density, device="cpu")
    tp = tins.with_baked_inscatter(tp, ts, device="cpu")
    o, d = tcam.generate_rays(tcam.camera_basis(cfg.camera), W, H, "cpu")
    ids = torch.arange(o.shape[0])
    fn = sr.make_spatial_subframe(world1, ts)
    got = fn(sr.shard_scene(world1, tp, device="cpu"), o, d, SEED, SUB, ids)
    ref = tpt.render_subframe(tp, ts, o, d, SEED, SUB, ids, device="cpu")
    return got, ref, fn


@pytest.fixture(scope="module")
def port(world1, density):
    return {m: _port(world1, density, m) for m in MODES}


@pytest.fixture(scope="module")
def jax_frames(density):
    out = {}
    for mode in MODES:
        # march_brick 0: the JAX spatial march takes cell rows.
        cfg = SceneConfig(cloud=CloudModel(size_m=1500.0), camera=CameraConfig(width=W, height=H),
                          rendering=CloudRendering(sample_step=1.0 / 128.0, max_depth=40,
                                                   mode=RenderMode[mode], march_brick=0))
        jp, js = jscene.build_scene(cfg, density)
        jp = jins.with_baked_inscatter(jp, js)
        o, d = jcam.generate_rays(jcam.camera_basis(cfg.camera), W, H)
        mesh = jmake_mesh(devices=jax.devices()[:1], axis_names=("space",))
        fn = jmake(mesh, js, axis="space")
        out[mode] = np.asarray(fn(jshard(mesh, jp, axis="space"), o, d, jnp.uint32(SEED),
                                  jnp.uint32(SUB), jnp.arange(o.shape[0], dtype=jnp.uint32)))
    return out


@pytest.mark.parametrize("mode", MODES)
def test_spatial_subframe_is_render_subframe_bitwise(port, mode):
    got, ref, fn = port[mode]
    assert got.shape == (W * H, 3) and torch.equal(got, ref)
    assert fn.last_phases >= 1 and fn.last_steps > 0


def test_spatial_subframe_uint8_is_render_subframe_bitwise(world1, density):
    got, ref, _ = _port(world1, density, MODES[0], "uint8")
    assert torch.equal(got, ref)


@pytest.mark.parametrize("mode", MODES)
def test_spatial_subframe_matches_jax(port, jax_frames, mode):
    got, ref = port[mode][0].numpy(), jax_frames[mode]
    assert got.shape == ref.shape and np.all(np.isfinite(got)) and ref.mean() > 0.01
    if mode == "SUN_SINGLE_SCATTER":
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
        return
    rel = np.abs(got - ref).max(-1) / np.maximum(np.abs(ref).max(-1), 1e-3)
    assert np.mean(rel <= 1e-4) >= 0.98
    assert abs(got.mean() - ref.mean()) <= 1e-4 * abs(ref.mean())


@pytest.mark.parametrize("shape", SHAPES)
def test_layouts_are_bitwise_the_one_slab_render(port, launched, shape):
    res = launched[shape].result()
    n_data, n_space = shape
    # The data groups' shards in order: ranks d * n_space of each group.
    out = torch.cat([res[d * n_space]["radiance"] for d in range(n_data)])
    assert torch.equal(out, port[MODES[0]][0])
    for d in range(n_data):
        shards = [res[d * n_space + s]["radiance"] for s in range(n_space)]
        assert all(torch.equal(x, shards[0]) for x in shards)
    assert all(r["backend"] == "gloo" and r["device"] == "cpu" for r in res)


@pytest.mark.parametrize("shape", SHAPES)
def test_each_rank_holds_only_its_slab(launched, shape):
    res = launched[shape].result()
    n_space = shape[1]
    slab = 24 // n_space
    for rank, r in enumerate(res):
        assert r["slab"] == (slab + 2 * sr.MIN_HALO, 24, 24)
        assert r["z0"] == (rank % n_space) * slab


def test_slabs_hold_the_grid_planes(world1, density):
    cfg = _tcfg(MODES[0])
    tp, ts = build_scene(cfg, density, device="cpu")
    tp = tins.with_baked_inscatter(tp, ts, device="cpu")
    full = tp.density_mips[0]
    for n in (2, 4):
        slab = 24 // n
        for i in range(n):
            sc = sr.slab_scene(tp, i, n, device="cpu")
            lo = i * slab
            assert torch.equal(sc.density[2:-2], full[lo:lo + slab])
            assert torch.equal(sc.inscatter[2:-2], tp.inscatter[lo:lo + slab])
            assert torch.equal(sc.density[0], full[max(lo - 2, 0)])
            assert torch.equal(sc.density[-1], full[min(lo + slab + 1, 23)])
    # The host path: slabs cut from host arrays match those of the params.
    host = sr.shard_scene(world1, tp, density=full.numpy(), inscatter=tp.inscatter.numpy(),
                          device="cpu")
    assert torch.equal(host.density, sr.shard_scene(world1, tp, device="cpu").density)


def test_sample_sky_and_shallow_depth_raise(world1, density):
    import dataclasses

    tp, ts = build_scene(_tcfg(MODES[0]), density, device="cpu")
    with pytest.raises(NotImplementedError, match="sample_sky"):
        sr.make_spatial_subframe(world1, dataclasses.replace(ts, sample_sky=True))
    with pytest.raises(ValueError, match="max_depth"):
        sr.make_spatial_subframe(world1, dataclasses.replace(ts, max_depth=1))
    with pytest.raises(ValueError, match="halo"):
        sr.make_spatial_subframe(world1, ts, halo=1)


def test_default_steps_per_phase(density):
    """``:186-193``: the steps a z-parallel ray needs to cross a slab."""
    _, ts = build_scene(_tcfg(MODES[0]), density, device="cpu")
    assert [sr.default_steps_per_phase(ts, 24 // n) for n in (1, 2, 4, 8)] == [128, 64, 32, 16]


def test_render_spatial_frame_is_the_subframes_mean(world1, density):
    cfg = _tcfg(MODES[2])
    tp, ts = build_scene(cfg, density, device="cpu")
    tp = tins.with_baked_inscatter(tp, ts, device="cpu")
    basis = tcam.camera_basis(cfg.camera)
    img = sr.render_spatial_frame(world1, tp, ts, W, H, basis, seed=SEED, n_subframes=2,
                                  device="cpu")
    o, d = tcam.generate_rays(basis, W, H, "cpu")
    acc = sum(tpt.render_subframe(tp, ts, o, d, SEED, s + 1, device="cpu") for s in range(2))
    np.testing.assert_array_equal(img, (acc / 2.0).reshape(H, W, 3).numpy())


def test_k9_wrapper_runs_the_plain_version_on_the_cpu(world1, density):
    cfg = _tcfg(MODES[0])
    tp, ts = build_scene(cfg, density, device="cpu")
    tp = tins.with_baked_inscatter(tp, ts, device="cpu")
    sc = sr.slab_scene(tp, 0, 1, device="cpu")
    rec = torch.zeros((8, sr.WIDTH))
    before = sr.spatial_phase.launches
    a = sr.spatial_phase(sc, ts, 5, torch.arange(8), 16, rec)
    b = sr.spatial_phase_plain(sc, ts, 5, torch.arange(8), 16, rec)
    assert torch.equal(a, b) and sr.spatial_phase.launches == before
