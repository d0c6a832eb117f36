"""Parity of the PyTorch port's dataset generator with the JAX package on
the CPU: the direction samplers, the descriptor quantizer, the cloud
preparation and the camera rotation; the first-scatter sampler (K7a's plain
version), the radiance estimator with its reschedule/densify loop (K7b's
plain version under it), the Disney descriptors and the baked
interpolation sets (K2's plain version), and ``tasks.collect``'s resume.

Inputs come from numpy seeds; the JAX side runs on the CPU as its own tests
run it.  The scene: the procedural cumulus 24^3 of seed 3 at 3000 m with
uint8 textures, step 1/128, ``max_depth`` 60 (``tests/
test_dataset_pipeline.py``'s cheap physics).  Stated tolerances:

- bitwise: ``quantize_u8`` / ``dequantize_u8`` at k/255 and one float32
  ulp either side; ``clouds.prepare``; ``camera_basis`` with and without a
  rotation; the radiance loop's ``schedule`` and experiment counts and its
  black labels (exactly 0);
- within 2e-7: ``uniform_on_sphere`` and ``uniform_on_disc`` (JAX-CPU and
  torch round ``sin``/``cos`` differently in the last bit);
- samples: found flags equal on >= 99.5 % of samples, positions within
  1e-4 and directions within 1e-6 where both found.  An ulp of a direction
  can flip an attempt's outcome, and the JAX march steps from the box
  entry while the port's jumps to the cloud AABB on the same step lattice
  (one product instead of repeated sums), so this is a share, like K1's
  flags;
- radiance labels: the 95 % confidence intervals of the two estimates
  overlap (``tests/test_radiance_collector.py``'s criterion: the two
  estimators' experiments differ in the last bits of a direction, then in
  their paths), and >= 90 % of the labels lie within 1e-3 of JAX's
  (relative; the experiments are mostly the same);
- descriptors: uint8 grids equal on >= 99.9 % of bytes and within 1
  elsewhere (a float32 ulp of a layer value on a k/255 boundary truncates
  to the byte below);
- baked sets: corners and probe positions equal, powers within 1e-6,
  grids as the descriptors.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepestscatter_tpu import scene as jscene
from deepestscatter_tpu.config import CloudModel, CloudRendering, PointRadianceConfig, SceneConfig
from deepestscatter_tpu.data import clouds as jclouds
from deepestscatter_tpu.data import collectors as jcol
from deepestscatter_tpu.ops import descriptor as jdesc
from deepestscatter_tpu.ops import rng as jrng
from deepestscatter_tpu.render import camera as jcam
from deepestscatter_tpu.render import inscatter as jins
from deepestscatter_tpu_torch import config as tconfig
from deepestscatter_tpu_torch import scene as tscene
from deepestscatter_tpu_torch import tasks as ttasks
from deepestscatter_tpu_torch.data import clouds as tclouds
from deepestscatter_tpu_torch.data import collectors as tcol
from deepestscatter_tpu_torch.data import scenesetups as tsetups
from deepestscatter_tpu_torch.ops import descriptor as tdesc
from deepestscatter_tpu_torch.ops import rng as trng
from deepestscatter_tpu_torch.render import camera as tcam
from deepestscatter_tpu_torch.render import inscatter as tins

N_SAMPLES = 400
SEED = 2


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _both_scenes(density, size_m=3000.0, sample_step=1.0 / 128.0, max_depth=60, dt="uint8",
                 bake=True):
    jcfg = SceneConfig(cloud=CloudModel(size_m=size_m), rendering=CloudRendering(
        march_dtype=dt, sample_step=sample_step, max_depth=max_depth))
    tcfg = tconfig.SceneConfig(cloud=tconfig.CloudModel(size_m=size_m),
                               rendering=tconfig.CloudRendering(
                                   march_dtype=dt, sample_step=sample_step, max_depth=max_depth))
    jp, js = jscene.build_scene(jcfg, density)
    tp, ts = tscene.build_scene(tcfg, density, device="cpu")
    if bake:
        jp = jins.with_baked_inscatter(jp, js)
        tp = tins.with_baked_inscatter(tp, ts, device="cpu")
    return (jp, js), (tp, ts)


@pytest.fixture(scope="module")
def scenes():
    density = tclouds.prepare(tclouds.load_density("procedural:24:3"))
    return _both_scenes(density)


@pytest.fixture(scope="module")
def samples(scenes):
    (jp, js), (tp, ts) = scenes
    jpos, jdir = jcol.generate_scatter_samples(jp, js, N_SAMPLES, SEED)
    t = tcol.generate_scatter_samples(tp, ts, N_SAMPLES, SEED)
    return np.asarray(jpos), np.asarray(jdir), t


def test_uniform_samplers_match_jax():
    rng = np.random.default_rng(0)
    u, v = (rng.random(4096).astype(np.float32) for _ in range(2))
    n = rng.normal(size=(4096, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    got = trng.uniform_on_sphere(torch.as_tensor(u), torch.as_tensor(v)).numpy()
    ref = np.asarray(jrng.uniform_on_sphere(jnp.asarray(u), jnp.asarray(v)))
    assert np.abs(got - ref).max() <= 2e-7
    got = trng.uniform_on_disc(torch.as_tensor(u), torch.as_tensor(v), torch.as_tensor(n)).numpy()
    ref = np.asarray(jrng.uniform_on_disc(jnp.asarray(u), jnp.asarray(v), jnp.asarray(n)))
    assert np.abs(got - ref).max() <= 2e-7


def test_quantize_u8_bitwise():
    """At k/255 and one float32 ulp either side, over k = 0 .. 255, and on
    random values: the truncating quantizer and the /256 dequantizer."""
    k = (np.arange(256, dtype=np.float32) / np.float32(255.0)).astype(np.float32)
    vals = np.concatenate([k, np.nextafter(k, np.float32(-1)), np.nextafter(k, np.float32(2)),
                           np.random.default_rng(1).random(5000).astype(np.float32)])
    vals = np.clip(vals, 0.0, 1.0).astype(np.float32)
    got = tdesc.quantize_u8(torch.as_tensor(vals)).numpy()
    ref = np.asarray(jdesc.quantize_u8(jnp.asarray(vals)))
    assert got.dtype == np.uint8 and np.array_equal(got, ref)
    assert got[255] == 255 and got[256 + 1] == 0  # just below 1/255 truncates to 0
    b = np.arange(256, dtype=np.uint8)
    assert np.array_equal(tdesc.dequantize_u8(torch.as_tensor(b)).numpy(),
                          np.asarray(jdesc.dequantize_u8(jnp.asarray(b))))


def test_prepare_matches_jax():
    raw = tclouds.load_density("procedural:16:5")
    assert np.array_equal(raw, jclouds.load_density("procedural:16:5"))
    got = tclouds.prepare(raw)
    assert got.shape == (18, 18, 18) and np.array_equal(got, jclouds.prepare(raw))


def test_vdb_without_npz_names_the_roadmap_item(tmp_path):
    """The roadmap item (D1's VDB reader) is ported: a ``.vdb`` without a
    converted ``.npz`` beside it is read directly, equal to the JAX
    package's read; a missing file raises as it does there."""
    from deepestscatter_tpu_torch.data import vdb as tvdb

    path = str(tmp_path / "cloud.vdb")
    for clouds in (tclouds, jclouds):
        with pytest.raises(FileNotFoundError):
            clouds.load_density(path)
    rng = np.random.default_rng(2)
    dense = rng.random((20, 12, 28), dtype=np.float32) * (rng.random((20, 12, 28)) < 0.3)
    tvdb.write_vdb(path, tvdb.VdbGrid("density", dense), compression="blosc")
    got = tclouds.load_density(path)
    assert got.shape == (24, 16, 32) and got.max() == dense.max()
    np.testing.assert_array_equal(got, jclouds.load_density(path))


@pytest.mark.parametrize("rotate", [False, True], ids=["none", "rotation"])
def test_camera_basis_rotation_bitwise(rotate):
    rot = None
    if rotate:
        a, b = 0.7, -0.4  # yaw about y, then pitch about x
        ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]])
        rot = (rx @ ry).astype(np.float32)
    cfg = tconfig.CameraConfig()
    from deepestscatter_tpu.config import CameraConfig

    got = tcam.camera_basis(cfg, rot)
    ref = jcam.camera_basis(CameraConfig(), rot)
    for name in ("eye", "u", "v", "w"):
        assert np.array_equal(getattr(got, name), np.asarray(getattr(ref, name))), name
    if rotate:
        assert not np.array_equal(got.eye, tcam.camera_basis(cfg).eye)


def test_scatter_samples_match_jax(samples):
    jpos, jdir, t = samples
    jfound = np.any(jdir != 0.0, axis=-1)
    tfound = t.found.numpy()
    assert tfound.sum() > 0.9 * N_SAMPLES
    assert (jfound == tfound).mean() >= 0.995
    both = jfound & tfound
    same = both & (np.abs(t.directions.numpy() - jdir).max(axis=-1) <= 1e-6)
    assert same.mean() >= 0.95 * both.mean()
    assert np.abs(t.positions.numpy() - jpos)[same].max() <= 1e-4
    # Unfound samples keep zeros, as the JAX loop leaves them.
    assert np.all(t.positions.numpy()[~tfound] == 0.0)


def test_radiance_matches_jax(scenes, samples):
    """32 samples at a loose gate: the same schedule and experiment counts;
    labels whose confidence intervals overlap, and >= 90 % of them within
    1e-3 of JAX's (relative): the two estimators trace the same experiments
    but where an ulp sends a path elsewhere, so a label normalised or
    merged wrongly is off by far more."""
    (jp, js), (tp, ts) = scenes
    jpos, jdir, t = samples
    idx = np.nonzero(t.found.numpy() & np.any(jdir != 0.0, axis=-1))[0][:32]
    cfg = PointRadianceConfig(max_threads=32 * 8, launches_per_update=4, rel_tol=0.5,
                              abs_tol=1e-9, black_min_experiments=64)
    tcfg = tconfig.PointRadianceConfig(**dataclasses.asdict(cfg))
    pos, d = t.positions[idx].contiguous(), t.directions[idx].contiguous()
    ref = jcol.estimate_point_radiance(jp, js, jnp.asarray(pos.numpy()),
                                       jnp.asarray(d.numpy()), cfg, seed=5, max_updates=4)
    got = tcol.estimate_point_radiance(tp, ts, pos, d, tcfg, seed=5, max_updates=4)
    assert got.schedule == ref.schedule
    assert np.array_equal(got.experiments, np.asarray(ref.experiments))
    assert np.array_equal(got.is_converged, np.asarray(ref.is_converged))
    # The two 95 % intervals overlap: both labels average as many
    # experiments of one distribution, so each interval is the port's.
    spread = np.abs(got.radiance.astype(np.float64) - np.asarray(ref.radiance, np.float64))
    assert np.all(spread <= 2.0 * got.ci95)
    assert (spread <= 1e-3 * np.abs(np.asarray(ref.radiance, np.float64))).mean() >= 0.9
    assert got.radiance.mean() > 0


def _black_scene(value, sample_step=1.0 / 16.0):
    density = np.full((8, 8, 8), value, np.float32)
    return _both_scenes(density, size_m=30.0, sample_step=sample_step, max_depth=8, dt="float32")


def test_black_samples_converge_under_the_default_config():
    """tests/test_radiance_collector.py's black case: an empty cloud, 4
    points at the box centre, the default config: one update of 2,560
    replicas x 100 experiments passes the 1e5 budget.  A step of 1/4 (an
    experiment leaves the empty box in 3 steps) keeps the plain loop short."""
    (jp, js), (tp, ts) = _black_scene(0.0, sample_step=0.25)
    pos = np.zeros((4, 3), np.float32)
    dirs = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (4, 1))
    ref = jcol.estimate_point_radiance(jp, js, pos, dirs, PointRadianceConfig(), seed=3,
                                       max_updates=3)
    got = tcol.estimate_point_radiance(tp, ts, torch.as_tensor(pos), torch.as_tensor(dirs),
                                       tconfig.PointRadianceConfig(), seed=3, max_updates=3)
    assert got.schedule == ref.schedule == ((4, 2560),)
    assert got.is_converged.all() and (got.experiments > 100_000).all()
    assert np.array_equal(got.experiments, np.asarray(ref.experiments))
    assert np.array_equal(got.radiance, np.zeros(4, np.float32))


def test_converged_points_freeze_and_survivors_densify():
    """tests/test_radiance_collector.py's mixed case: bright points in a
    uniform cloud converge early, black points outside the box wait for
    the budget and receive the freed replicas; the same schedule and
    counts as the JAX loop."""
    (jp, js), (tp, ts) = _black_scene(1.0)
    bbox = np.asarray(jp.bbox_size)
    pos = np.concatenate([np.zeros((8, 3), np.float32),
                          np.tile((bbox * 4.0).astype(np.float32), (8, 1))])
    dirs = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (16, 1))
    cfg = PointRadianceConfig(max_threads=256, launches_per_update=1, rel_tol=0.5,
                              abs_tol=1e-9, black_min_experiments=100)
    ref = jcol.estimate_point_radiance(jp, js, pos, dirs, cfg, seed=7, max_updates=64)
    got = tcol.estimate_point_radiance(tp, ts, torch.as_tensor(pos), torch.as_tensor(dirs),
                                       tconfig.PointRadianceConfig(**dataclasses.asdict(cfg)),
                                       seed=7, max_updates=64)
    assert got.schedule == ref.schedule
    assert np.array_equal(got.experiments, np.asarray(ref.experiments))
    assert got.is_converged.all() and (got.radiance[:8] > 0).all()
    assert np.array_equal(got.radiance[8:], np.zeros(8, np.float32))
    replicas = [r for _, r in got.schedule]
    assert replicas == sorted(replicas) and replicas[-1] > replicas[0]


def test_radiance_resumes_from_its_state_file(scenes, samples, tmp_path):
    """Killed after 1 update (the state saved every update), resumed to 2:
    the same labels and counts as 2 updates in one run."""
    _, (tp, ts) = scenes
    _, _, t = samples
    idx = torch.nonzero(t.found).flatten()[:8]
    pos, d = t.positions[idx].contiguous(), t.directions[idx].contiguous()
    cfg = tconfig.PointRadianceConfig(max_threads=64, launches_per_update=2, rel_tol=0.01,
                                      abs_tol=1e-9, black_min_experiments=10**9)
    state = str(tmp_path / "state.npz")
    tcol.estimate_point_radiance(tp, ts, pos, d, cfg, seed=1, max_updates=1, state_path=state,
                                 save_every=1)
    resumed = tcol.estimate_point_radiance(tp, ts, pos, d, cfg, seed=1, max_updates=2,
                                           state_path=state, save_every=1)
    whole = tcol.estimate_point_radiance(tp, ts, pos, d, cfg, seed=1, max_updates=2)
    assert np.array_equal(resumed.experiments, whole.experiments)
    assert np.array_equal(resumed.radiance, whole.radiance)
    assert len(resumed.schedule) == 1 and len(whole.schedule) == 2


def test_descriptors_match_jax(scenes, samples):
    (jp, js), (tp, ts) = scenes
    _, _, t = samples
    idx = torch.nonzero(t.found).flatten()[:128]
    pos, d = t.positions[idx].contiguous(), t.directions[idx].contiguous()
    got = tcol.collect_disney_descriptors(tp, ts, pos, d)
    ref = jcol.collect_disney_descriptors(jp, js, jnp.asarray(pos.numpy()), jnp.asarray(d.numpy()))
    assert got.shape == (128, 2250) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - np.asarray(ref).astype(np.int16))
    assert (diff == 0).mean() >= 0.999 and diff.max() <= 1
    assert got.max() > 0


def test_baked_sets_match_jax(scenes, samples):
    (jp, js), (tp, ts) = scenes
    _, _, t = samples
    idx = torch.nonzero(t.found).flatten()[:96]
    pos = t.positions[idx].contiguous()
    got = tcol.collect_baked_sets(tp, ts, pos)
    ref = jcol.collect_baked_sets(jp, js, jnp.asarray(pos.numpy()))
    assert got.dtype == ref.dtype
    for c in "abcd":
        assert np.array_equal(got[c]["position"], ref[c]["position"]), c
        assert np.array_equal(got[c]["direction"], ref[c]["direction"]), c
        assert np.abs(got[c]["power"] - ref[c]["power"]).max() <= 1e-6, c
        diff = np.abs(got[c]["grid"].astype(np.int16) - ref[c]["grid"].astype(np.int16))
        assert (diff == 0).mean() >= 0.999 and diff.max() <= 1, c
    assert np.abs(sum(got[c]["power"] for c in "abcd") - 1.0).max() <= 1e-4


def test_collect_overwrite_then_continue(tmp_path):
    """Samples and labels for two scenes; CONTINUE then processes none;
    the radiance state file is gone once the labels are stored."""
    triplet = tsetups.generate(str(tmp_path), ["procedural:24:3", "procedural:24:4"], seed=1,
                               scenes_per_cloud=2)
    store = next(s for s in (triplet.train, triplet.validation, triplet.test)
                 if s.count("SceneSetup") >= 2)
    base = tconfig.SceneConfig(rendering=tconfig.CloudRendering(
        march_dtype="uint8", sample_step=1.0 / 128.0, max_depth=20))
    # A gate every label passes within two updates.
    rc = tconfig.PointRadianceConfig(max_threads=256, launches_per_update=4, rel_tol=1.0,
                                     abs_tol=1.0, black_min_experiments=16)
    kw = dict(base=base, radiance_cfg=rc, batch_size=32, max_scenes=2, verbose=False,
              device="cpu")
    for rt in ("ScatterSample", "Result"):
        assert ttasks.collect(store, rt, ttasks.CollectMode.OVERWRITE, **kw) == 2
        assert store.count(rt) == 64
        assert ttasks.collect(store, rt, ttasks.CollectMode.CONTINUE, **kw) == 0
    assert not any(p.name.startswith(".radiance_state") for p in tmp_path.rglob("*"))
    samples = store.table("ScatterSample").read(0, 64)
    assert np.array_equal(samples["scene_setup_id"], np.repeat([0, 1], 32))
    labels = store.table("Result").read(0, 64)["light_intensity"]
    assert np.isfinite(labels).all() and labels.max() > 0
