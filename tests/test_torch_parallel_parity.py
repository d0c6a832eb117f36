"""Multi-device rendering and training of the PyTorch port on the CPU
(``deepestscatter_tpu_torch.parallel``, ``train.trainer``'s ``mesh``,
``graft``), against the JAX package on its 8-device virtual CPU mesh
(``tests/conftest.py``) and against the port's one-device paths.

World 1 runs in this process over gloo; worlds 2 and 4 run as processes
of their own through ``parallel.launch.run`` (gloo on the CPU).  The
scenes are the JAX package's own test scenes (``tests/test_parallel.py``:
cumulus 24^3 of seed 2, 1200 m, 32 x 16; ``tests/test_spatial.py``:
cumulus 16^3 of seed 6).  A tick renders 2 subframes (the JAX test's 10
take ~20 s in the plain path tracer's lockstep loop on the CPU).  Stated
tolerances:

- bitwise: the sharded tick's state against the port's
  ``ProgressiveRenderer`` at 1 and 2 subframes a tick, and across worlds
  1, 2 and 4 at one subframe (K4's draws key on global ray ids and it
  folds a pixel's samples in sample order, whatever the shard); the
  sharded bake against the port's ``bake``; ``HaloSlabGrid.scatter``
  against JAX's and ``exchange_halos`` against ``scatter``; the
  unconverged count;
- the port's sharded tick against JAX's ``ShardedProgressiveRenderer``:
  the rule of ``test_torch_pt_parity.py`` for deep paths (JAX-CPU and
  torch round ``exp``/``log``/``sin``/``cos`` apart in the last bit; a
  flipped crossing moves a path), here at ``max_depth`` 2000: the mean
  within a relative 1e-4 on >= 95 % of pixels and its image mean within a
  relative 1e-4 (measured 96.7 %, 1.7e-5); m2, two samples' squared
  difference, within a relative 1e-3 on >= 97 % of pixels and its image
  mean within 3e-4 (measured 99.0 %, 9.9e-5; 92.2 % within 1e-4);
- the sharded bake against JAX's sharded bake: atol 1e-6, the JAX
  package's own tolerance between its sharded and unsharded bakes (XLA
  fuses the division by 255 differently per program; measured 6e-8);
- data-parallel training at world 2 against JAX's ``make_train_step(mesh=
  ...)`` on the 8-device mesh, from the same converted weights, 3 steps
  at batch 16: each loss within rtol 1e-4, the parameters within a
  norm-relative 1e-3 and every element within 2 lr x steps
  (``test_torch_train_parity.py``'s rule); against the port at world 1,
  the same tolerances (the shard gradients sum in another order).
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from deepestscatter_tpu import scene as jscene
from deepestscatter_tpu.config import CameraConfig, CloudModel, ProgressiveConfig, SceneConfig
from deepestscatter_tpu.data import procedural as jproc
from deepestscatter_tpu.models.rpnn import DisneyModel as JaxDisneyModel
from deepestscatter_tpu.parallel import make_mesh as jmake_mesh
from deepestscatter_tpu.parallel import spatial as jspatial
from deepestscatter_tpu.parallel.render import ShardedProgressiveRenderer as JaxSharded
from deepestscatter_tpu.render import inscatter as jins
from deepestscatter_tpu.train import trainer as jtrainer
from deepestscatter_tpu_torch import config as tconfig
from deepestscatter_tpu_torch import graft
from deepestscatter_tpu_torch.models import convert
from deepestscatter_tpu_torch.models.rpnn import DisneyModel
from deepestscatter_tpu_torch.parallel import jobs, launch
from deepestscatter_tpu_torch.parallel import mesh as tmesh
from deepestscatter_tpu_torch.parallel.render import ShardedProgressiveRenderer
from deepestscatter_tpu_torch.render import inscatter as tins
from deepestscatter_tpu_torch.render.progressive import ProgressiveRenderer, unconverged_count
from deepestscatter_tpu_torch.scene import build_scene

SEED = 3
SUBFRAMES = 2
LR = 1e-3
JOBS = "deepestscatter_tpu_torch.parallel.jobs:several"


def _cfgs(subframes):
    # One subframe: the gate before min_subframes (every pixel); two: the
    # CI gate itself (min_subframes 2).
    prog = dict(subframes_per_tick=subframes)
    if subframes > 1:
        prog["min_subframes"] = subframes
    jcfg = SceneConfig(cloud=CloudModel(size_m=1200.0), camera=CameraConfig(width=32, height=16),
                       progressive=ProgressiveConfig(**prog))
    tcfg = tconfig.SceneConfig(cloud=tconfig.CloudModel(size_m=1200.0),
                               camera=tconfig.CameraConfig(width=32, height=16),
                               progressive=tconfig.ProgressiveConfig(**prog))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def world1():
    """This process as a world of one (gloo)."""
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{launch.free_port()}",
                            world_size=1, rank=0)
    yield tmesh.make_mesh(device_type="cpu")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def rig():
    density = jproc.cumulus(resolution=24, seed=2)
    _, tcfg = _cfgs(SUBFRAMES)
    tp, ts = build_scene(tcfg, density, device="cpu")
    insc = tins.bake(tp, ts, device="cpu").numpy()
    tp, ts = build_scene(tcfg, density, insc, device="cpu")
    small = jproc.cumulus(resolution=16, seed=6)
    grid = np.random.default_rng(0).random((32, 4, 4)).astype(np.float32)
    return dict(density=density, insc=insc, tp=tp, ts=ts, small=small, grid=grid)


@pytest.fixture(scope="module")
def jax_tick(rig):
    jcfg, _ = _cfgs(SUBFRAMES)
    jp, js = jscene.build_scene(jcfg, rig["density"])
    jp = jins.with_baked_inscatter(jp, js)
    r = JaxSharded(jcfg, jp, js, jmake_mesh(), seed=SEED)
    count = r.tick()
    return dict(mean=np.asarray(r.state.mean), m2=np.asarray(r.state.m2), count=count)


def _calls(rig, world):
    cfg1, cfg2 = _cfgs(1)[1], _cfgs(SUBFRAMES)[1]
    calls = [("tick", dict(cfg=cfg1, density=rig["density"], seed=SEED, inscatter=rig["insc"])),
             ("tick", dict(cfg=cfg2, density=rig["density"], seed=SEED, inscatter=rig["insc"])),
             ("sharded_bake", dict(cfg=tconfig.SceneConfig(cloud=tconfig.CloudModel(size_m=1200.0)),
                                   density=rig["small"])),
             ("halos", dict(grid=rig["grid"]))]
    if world == 2:
        calls.append(("train_steps", _train_kwargs()))
    return calls


@pytest.fixture(scope="module")
def launched(rig):
    """Worlds 2 and 4 running ``_calls`` in the background (their ranks
    while this process computes world 1)."""
    with ThreadPoolExecutor(2) as pool:
        yield {w: pool.submit(launch.run, JOBS, w, device="cpu", threads=1,
                              calls=_calls(rig, w)) for w in (2, 4)}


@pytest.fixture(scope="module")
def worlds(launched):
    """Worlds 2 and 4's results of ``_calls``, a list a rank."""
    return {w: f.result() for w, f in launched.items()}


def _port_ticks(rig, mesh, subframes):
    _, tcfg = _cfgs(subframes)
    one = ProgressiveRenderer(tcfg, rig["tp"], rig["ts"], seed=SEED, device="cpu")
    one.tick()
    sharded = ShardedProgressiveRenderer(tcfg, rig["tp"], rig["ts"], mesh, seed=SEED,
                                         device="cpu")
    count = sharded.tick()
    return one, sharded, count


@pytest.fixture(scope="module")
def ticks(rig, world1, launched):
    return {s: _port_ticks(rig, world1, s) for s in (1, SUBFRAMES)}


@pytest.mark.parametrize("subframes", [1, SUBFRAMES])
def test_world1_tick_is_the_unsharded_tick_bitwise(ticks, subframes):
    one, sharded, count = ticks[subframes]
    for f in ("mean", "m2", "count"):
        assert torch.equal(getattr(sharded.state, f), getattr(one.state, f)), f
    assert sharded.state.subframe_id == one.state.subframe_id == subframes
    np.testing.assert_array_equal(sharded.hdr_image(), one.hdr_image())


def _close_deep(got, ref, rtol, share, mean_rtol):
    assert got.shape == ref.shape and np.all(np.isfinite(got))
    rel = np.abs(got - ref).max(-1) / np.maximum(np.abs(ref).max(-1), 1e-3)
    assert np.mean(rel <= rtol) >= share
    assert abs(got.mean() - ref.mean()) <= mean_rtol * abs(ref.mean())


def test_sharded_tick_matches_jax(ticks, jax_tick):
    _, sharded, _ = ticks[SUBFRAMES]
    _close_deep(sharded.state.mean.numpy(), jax_tick["mean"], 1e-4, 0.95, 1e-4)
    _close_deep(sharded.state.m2.numpy(), jax_tick["m2"], 1e-3, 0.97, 3e-4)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("subframes", [1, SUBFRAMES])
def test_ticks_bitwise_across_worlds(ticks, worlds, world, subframes):
    one = ticks[subframes][0]
    res = worlds[world]
    r = res[0][0 if subframes == 1 else 1]
    assert [x[0 if subframes == 1 else 1]["shard"] for x in res] == [(512 // world, 3)] * world
    assert torch.equal(r["mean"], one.state.mean) and torch.equal(r["m2"], one.state.m2)
    assert torch.equal(r["count"], one.state.count)
    np.testing.assert_array_equal(r["image"], one.hdr_image())
    assert all(x[0]["backend"] == "gloo" and x[0]["device"] == "cpu" for x in res)


def test_unconverged_count(ticks, worlds):
    """Every pixel before ``min_subframes`` (as JAX's renderer reports, the
    JAX test's gate); after it, the group's sum of the shards' counts,
    equal to the one-device gate's at every world size."""
    assert ticks[1][2] == 512
    assert all(x[0]["counts"] == [512] for w in worlds.values() for x in w)
    one, sharded, count = ticks[SUBFRAMES]
    ref = int(unconverged_count(one.state, _cfgs(SUBFRAMES)[1].progressive))
    assert count == ref and 0 < ref < 512
    assert all(x[1]["counts"] == [ref] for w in worlds.values() for x in w)


def test_sharded_bake_matches_jax_and_bake(rig, worlds):
    jp, js = jscene.build_scene(SceneConfig(cloud=CloudModel(size_m=1200.0)), rig["small"])
    ref = np.asarray(jspatial.sharded_inscatter_bake(jmake_mesh(), jp, js))
    for res in worlds.values():
        for r in res:
            assert torch.equal(r[2]["sharded"], r[2]["whole"])
    np.testing.assert_allclose(worlds[4][0][2]["sharded"].numpy(), ref, rtol=0, atol=1e-6)


def test_sharded_bake_in_one_process(rig, world1):
    """World 1, and uneven plane splits of the K3 range (17 planes over 4
    parts)."""
    tp, ts = build_scene(tconfig.SceneConfig(cloud=tconfig.CloudModel(size_m=1200.0)),
                         rig["small"], device="cpu")
    from deepestscatter_tpu_torch.parallel import spatial

    whole = tins.bake(tp, ts, device="cpu")
    assert torch.equal(spatial.sharded_inscatter_bake(world1, tp, ts, device="cpu"), whole)
    parts = [spatial.plane_split(17, 4, i) for i in range(4)]
    assert parts == [(0, 5), (5, 9), (9, 13), (13, 17)]
    cat = torch.cat([tins.bake(tp, ts, device="cpu", planes=spatial.plane_split(16, 3, i))
                     for i in range(3)])
    assert torch.equal(cat, whole)


@pytest.mark.parametrize("world", [2, 4])
def test_halo_slabs_match_jax_and_the_exchange(rig, worlds, world):
    mesh = jmake_mesh(devices=jax.devices()[:world])
    ref = np.asarray(jspatial.HaloSlabGrid(mesh, halo=1).scatter(jnp.asarray(rig["grid"])))
    for d, r in enumerate(worlds[world]):
        np.testing.assert_array_equal(r[3]["scatter"].numpy(), ref[d])
        assert torch.equal(r[3]["exchange"], r[3]["scatter"])
        # replicate_coarse_mips: level 0 stays the rank's, level 1 is rank 0's.
        fine, coarse = r[3]["mips"]
        assert bool((fine == d).all()) and bool((coarse == 10.0).all())


def test_halo_slabs_in_one_process(rig, world1):
    from deepestscatter_tpu_torch.parallel.spatial import HaloSlabGrid

    slabs = HaloSlabGrid(world1, halo=1)
    s = slabs.scatter(rig["grid"], "cpu")
    g = torch.from_numpy(rig["grid"])
    assert torch.equal(s, torch.cat([g[:1], g, g[-1:]]))
    assert torch.equal(slabs.exchange_halos(g), s)


def _train_kwargs():
    rng = np.random.default_rng(11)
    batches = [(rng.random((16, 10, 226)).astype(np.float32),
                (rng.random(16) * 3.0).astype(np.float32)) for _ in range(3)]
    jm = JaxDisneyModel()
    variables = jm.init(jax.random.PRNGKey(566), jnp.zeros((1, 10, 226)))
    return dict(model=DisneyModel(), state=convert.disney_from_flax(variables),
                batches=batches, lr=LR)


def _params_close(got: torch.Tensor, ref: torch.Tensor, steps: int):
    assert float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref)) <= 1e-3
    assert float((got - ref).abs().max()) <= 2 * LR * steps


def test_data_parallel_training_matches_jax(worlds, world1):
    kw = _train_kwargs()
    jm = JaxDisneyModel()
    variables = jm.init(jax.random.PRNGKey(566), jnp.zeros((1, 10, 226)))
    tx = jtrainer.adam_amsgrad(LR)
    step = jtrainer.make_train_step(lambda p, b: jm.apply(p, b), tx, mesh=jmake_mesh())
    state = jtrainer.TrainState(variables, tx.init(variables), jnp.int32(0))
    ref_losses = []
    for z, labels in kw["batches"]:
        state, loss = step(state, jnp.asarray(z), jnp.asarray(labels))
        ref_losses.append(float(loss))
    ref_state = convert.disney_from_flax(state.params)
    ref = torch.cat([ref_state[k].reshape(-1) for k in DisneyModel().state_dict()])
    r0, r1 = (r[4] for r in worlds[2])
    assert r0["losses"] == r1["losses"] and torch.equal(r0["params"], r1["params"])
    np.testing.assert_allclose(r0["losses"], ref_losses, rtol=1e-4)
    _params_close(r0["params"], ref, 3)
    one = jobs.train_steps(**kw, device="cpu")
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=1e-4)
    _params_close(r0["params"], one["params"], 3)


def test_world1_training_is_the_undistributed_step_bitwise(world1):
    """At one rank the all_reduce and the division by 1 change nothing."""
    a = jobs.train_chunk(64, 16, 3, distributed=True, device="cpu")
    b = jobs.train_chunk(64, 16, 3, distributed=False, device="cpu")
    assert torch.equal(a["losses"], b["losses"]) and torch.equal(a["params"], b["params"])


def test_trainer_with_a_mesh_at_world_1_is_the_trainer(world1, tmp_path):
    """``Trainer(mesh=)`` on host batches: at one rank the same
    trajectory, losses and metrics as without a mesh, bitwise."""
    from deepestscatter_tpu_torch.models.blocks import flax_init
    from deepestscatter_tpu_torch.train import trainer

    rng = np.random.default_rng(2)
    batches = [({"z": rng.random((8, 10, 226)).astype(np.float32)},
                (rng.random(8) * 3.0).astype(np.float32)) for _ in range(2)]
    runs = []
    for mesh in (None, world1):
        t = trainer.Trainer(
            name="DisneyModel", model=flax_init(DisneyModel(), 566, "cpu"),
            apply_fn=lambda m, b: m(b["z"]), train_batches=lambda e: iter(batches),
            val_batch=lambda: batches[0],
            config=tconfig.TrainConfig(run_dir=str(tmp_path / str(mesh is None)),
                                       validate_every=1),
            device="cpu", mesh=mesh)
        t.run(epochs=2)
        runs.append((trainer.flat_params(t.model), t.best_val, t.step))
    (pa, va, sa), (pb, vb, sb) = runs
    assert torch.equal(pa, pb) and va == vb and sa == sb == 4
    assert trainer.data_shard(16, world1.get_group("data")) == slice(0, 16)
    assert trainer.data_shard(16, None) == slice(0, 16)


def test_initialize_distributed_raises_on_a_bad_request():
    """In a fresh process (this one's group is up): the bare call without
    a rendezvous returns False; an explicit request that fails raises."""
    code = (
        "import os\n"
        "from deepestscatter_tpu_torch.parallel import mesh\n"
        "for k in mesh.RENDEZVOUS_ENV: os.environ.pop(k, None)\n"
        "assert mesh.initialize_distributed(device='cpu') is False\n"
        "try:\n"
        "    mesh.initialize_distributed(device='cpu', backend='no_such_backend',\n"
        "                                init_method='tcp://localhost:1', world_size=1, rank=0)\n"
        "except Exception as e:\n"
        "    print('raised', type(e).__name__)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(Path(graft.__file__).resolve().parents[1]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("raised")


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_the_cpu(n, capsys):
    out = graft.dryrun_multichip(n, device="cpu")
    assert len(out) == n and all(r["backend"] == "gloo" for r in out)
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["render_mean"]) for r in out)
    assert np.isfinite(out[0]["mean2d"])
    assert f"dryrun_multichip({n})" in capsys.readouterr().out


def test_entry_renders_on_the_cpu():
    fn, args = graft.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (16 * 8, 3) and bool(torch.isfinite(out).all())
