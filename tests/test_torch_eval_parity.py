"""The port against the JAX package's end-to-end evaluation on the CPU:
the held-out scene's set-up, the golden-image comparison and the
statistical gate ``chip_smoke.py`` holds the card's converged path-traced
render to against the committed JAX ground truth
(``runs/eval_e2e/renders_512x256/eval.PT.exr``).

- ``tasks.eval_scene`` gives the SceneSetup record and the base config of
  ``tools/eval_e2e.py:124-149`` for ``EVAL_r05.json``'s held-out scene:
  the record equal bytewise, every config field the two packages share
  equal, and the scene it builds (without the bake) equal: the prepared
  density grid bitwise, the statics' scalars exactly.
- ``utils/compare.py``'s ``tone_mapped`` and ``diff_image`` within 4e-7
  of the JAX package's (a few float32 ulps of values in [0, 1]) and
  ``rms_bias`` within 1e-6 of it (relative), on seeded numpy images.  They
  are not bitwise: XLA's float32 ``pow`` (the 1/2.2 gamma) and its order
  of the mean luminance's sum differ from PyTorch's in the last bit, and
  an ulp of the mean moves every pixel's map (measured: 31-36 % of the
  elements differ, by up to 5 ulps).
- ``render_agreement``'s standard error of the image mean matches the
  spread of simulated renders whose pixel channels deviate together (as
  the path tracer's do), and ``pool_renders`` equals the Welford state of
  all the pooled samples; ``paired_difference`` passes a render against
  itself with a tenth of its pixels parted and refuses it scaled by 1.02.
- ``render_agreement``'s gate passes two renders of different seeds and
  refuses one of them scaled by 1.02: 32 x 16 pixels on the 16^3 cumulus
  at 1000 m, single scatter (a path's radiance has little variance, so 16
  subframes a render separate a 2 % scale from the noise), uint8, step
  1/32.
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

from deepestscatter_tpu import tasks as jax_tasks
from deepestscatter_tpu.config import CameraConfig as JaxCamera
from deepestscatter_tpu.config import CloudRendering as JaxRendering
from deepestscatter_tpu.config import SceneConfig as JaxScene
from deepestscatter_tpu.data import clouds as jax_clouds
from deepestscatter_tpu.data import records as jax_records
from deepestscatter_tpu.utils import compare as jax_compare

from deepestscatter_tpu_torch import build_scene, config, tasks, with_baked_inscatter
from deepestscatter_tpu_torch.data import clouds, procedural
from deepestscatter_tpu_torch.render import progressive
from deepestscatter_tpu_torch.utils import compare

EVAL = json.loads((Path(__file__).resolve().parents[1] / "EVAL_r05.json").read_text())


def _jax_eval_scene():
    """The held-out scene as tools/eval_e2e.py sets it up."""
    held = EVAL["held_out_scene"]
    width, height = EVAL["resolution"]
    setup = np.zeros(1, jax_records.SCENE_SETUP)[0]
    setup["cloud_path"] = held["cloud"].encode()
    setup["cloud_size_m"] = held["size_m"]
    setup["light_direction"] = np.asarray(held["light"], np.float32)
    base = JaxScene(rendering=JaxRendering(rr_start_depth=64, rr_survival=0.98,
                                           march_dtype="uint8"))
    return setup, dataclasses.replace(base, camera=JaxCamera(width=width, height=height))


def _shared_fields(port, ref, path=""):
    """Every field of the port's config dataclass tree against the JAX
    one's of the same name → the names that differ."""
    out = []
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            out += _shared_fields(a, b, f"{path}{f.name}.")
        elif (a.value if hasattr(a, "value") else a) != (b.value if hasattr(b, "value") else b):
            out.append(f"{path}{f.name}: {a!r} != {b!r}")
    return out


def test_eval_scene_equals_the_jax_eval():
    width, height = EVAL["resolution"]
    setup, base = tasks.eval_scene(EVAL["held_out_scene"], width, height)
    ref_setup, ref_base = _jax_eval_scene()
    assert setup.dtype == ref_setup.dtype and setup.tobytes() == ref_setup.tobytes()
    assert _shared_fields(base, ref_base) == []
    assert (base.rendering.rr_start_depth, base.rendering.rr_survival) == (64, 0.98)
    assert (base.camera.width, base.camera.height) == (512, 256)

    cfg, params, static = tasks.scene_from_setup(setup, base, bake=False, device="cpu")
    ref_cfg, ref_params, ref_static = jax_tasks.scene_from_setup(ref_setup, ref_base, bake=False)
    assert _shared_fields(cfg, ref_cfg) == []
    path = EVAL["held_out_scene"]["cloud"]
    assert np.array_equal(clouds.prepare(clouds.load_density(path)),
                          jax_clouds.prepare(jax_clouds.load_density(path)))
    assert static.grid_shape == tuple(ref_static.grid_shape) == (66, 66, 66)
    for name in ("n_mips", "sample_step", "density_multiplier", "max_depth",
                 "sun_cos_half_angle", "sun_solid_angle_ratio", "minimal_ray_distance",
                 "rr_start_depth", "rr_survival"):
        assert getattr(static, name) == getattr(ref_static, name), name
    assert static.mode.value == ref_static.mode.value
    assert np.array_equal(params.bbox_size.numpy(), np.asarray(ref_params.bbox_size))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tone_map_and_rms_within_a_few_ulps_of_jax(seed):
    rng = np.random.default_rng(seed)
    shape = (256, 512, 3) if seed == 0 else (16, 32, 3)
    a = rng.gamma(0.8, 2.0, shape).astype(np.float32)
    b = (a * rng.uniform(0.9, 1.1, shape)).astype(np.float32)
    got, ref = compare.tone_mapped(a), np.asarray(jax_compare.tone_mapped(a))
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(got - ref).max() <= 4e-7
    assert compare.rms_bias(a, b) == pytest.approx(jax_compare.rms_bias(a, b), rel=1e-6)
    d = compare.diff_image(a, b)
    assert np.abs(d - jax_compare.diff_image(a, b)).max() <= 8e-7


@pytest.fixture(scope="module")
def two_renders():
    """Two 16-subframe renders (seeds 1 and 2) of 32 x 16 pixels: the
    port's progressive loop on the CPU (K4's plain version)."""
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=1000.0),
        camera=config.CameraConfig(width=32, height=16),
        rendering=config.CloudRendering(march_dtype="uint8", sample_step=1.0 / 32.0,
                                        mode=config.RenderMode.SUN_SINGLE_SCATTER),
        progressive=config.ProgressiveConfig(subframes_per_tick=16),
    )
    params, static = build_scene(cfg, procedural.cumulus(16, seed=3), device="cpu")
    params = with_baked_inscatter(params, static, device="cpu")
    out = []
    for seed in (1, 2):
        r = progressive.ProgressiveRenderer(cfg, params, static, seed=seed, device="cpu")
        r.tick()
        st = r.state
        out.append((st.mean.reshape(16, 32, 3).numpy(), st.m2.reshape(16, 32, 3).numpy(),
                    st.count.reshape(16, 32).numpy()))
    return out


def test_gate_passes_two_seeds_and_refuses_a_scaled_render(two_renders):
    (mean, m2, count), (other, _, _) = two_renders
    assert int(count.min()) == 16 and float(mean.mean()) > 0.0
    a = compare.render_agreement(mean, m2, count, other)
    assert a.passes(), a
    assert abs(a.mean_z) <= 4.0 and a.rms <= 1.5 * a.noise_rms
    assert a.mean == pytest.approx(float(mean.astype(np.float64).mean()))
    scaled = compare.render_agreement(1.02 * mean, 1.02**2 * m2, count, other)
    assert not scaled.passes(), scaled
    assert scaled.mean_z > 4.0
    # The tone map divides by the mean luminance: a scale leaves the RMS.
    assert scaled.rms == pytest.approx(a.rms, rel=1e-4)


def test_gate_standard_errors_from_the_welford_moments():
    """mean_se and noise_rms from m2 / (n (n - 1)); zero noise makes any
    difference fail and an equal image pass."""
    rng = np.random.default_rng(4)
    mean = rng.uniform(0.5, 2.0, (8, 16, 3))
    count = np.full((8, 16), 10.0)
    m2 = np.full((8, 16, 3), 9.0 * 0.01)  # se 0.1 / sqrt(10) a channel
    a = compare.render_agreement(mean, m2, count, mean, reference_noise=0.0)
    pixels = count.size  # a pixel's channels deviate together: se 0.1 / sqrt(10) a pixel
    assert a.mean_se == pytest.approx(np.sqrt(pixels * 0.001) / pixels)
    assert a.mean_z == 0.0 and a.rms == 0.0 and a.noise_rms > 0.0 and a.passes()
    flat = compare.render_agreement(mean, np.zeros_like(m2), count, mean + 1e-3)
    assert flat.mean_se == 0.0 and not flat.passes()
    assert compare.render_agreement(mean, np.zeros_like(m2), count, mean).passes()


def _welford(x):
    """Samples [R, H, W, n, 3] → Welford states (mean, m2 [R, H, W, 3],
    count [R, H, W])."""
    mean = x.mean(axis=-2)
    m2 = ((x - mean[..., None, :]) ** 2).sum(axis=-2)
    return mean, m2, np.full(x.shape[:3], float(x.shape[-2]))


def test_gate_standard_error_matches_the_spread_of_renders():
    """Renders whose pixel channels deviate together, as the path tracer's
    do (a grey path radiance plus a colour fixed a pixel): ``mean_se`` with
    no reference noise is the spread of their image means within 10 %, where
    the channels taken as independent would understate it by sqrt(3)."""
    rng = np.random.default_rng(7)
    renders, h, w, n = 400, 8, 16, 40
    scale = rng.uniform(0.2, 3.0, (h, w, 1, 1))
    colour = rng.uniform(0.0, 0.5, (h, w, 1, 3))
    x = rng.exponential(1.0, (renders, h, w, n, 1)) * scale + colour
    mean, m2, count = _welford(np.broadcast_to(x, (renders, h, w, n, 3)))
    assert np.allclose(m2[..., 0], m2[..., 2], rtol=1e-9)
    spread = mean.mean(axis=(1, 2, 3)).std(ddof=1)
    se = np.mean([compare.render_agreement(mean[r], m2[r], count[r], mean[r],
                                           reference_noise=0.0).mean_se for r in range(renders)])
    assert se == pytest.approx(spread, rel=0.1)
    var = m2 / (count[..., None] * (count[..., None] - 1.0))
    independent = np.sqrt(var[0].sum()) / var[0].size
    assert spread / independent == pytest.approx(np.sqrt(3.0), rel=0.15)


def test_pool_renders_equals_the_state_of_all_samples():
    rng = np.random.default_rng(8)
    x = rng.gamma(0.7, 2.0, (3, 4, 5, 6, 3))
    parts = [_welford(x[i:i + 1]) for i in range(3)]
    mean, m2, count = compare.pool_renders([(m[0], v[0], c[0]) for m, v, c in parts])
    whole = _welford(x.transpose(1, 2, 0, 3, 4).reshape(1, 4, 5, 18, 3))
    assert np.array_equal(count, whole[2][0])
    assert np.allclose(mean, whole[0][0], rtol=1e-12) and np.allclose(m2, whole[1][0], rtol=1e-12)


def test_paired_difference_passes_parted_paths_and_refuses_a_scaled_render(two_renders):
    """A render against itself with a tenth of its pixels from another
    seed (paths parted by another float library) passes the same-seed gate
    (|diff| <= Z_MAX standard errors); the render scaled by 1.02 fails it."""
    (mean, _, _), (other, _, _) = two_renders
    parted = np.random.default_rng(9).uniform(size=mean.shape[:2]) < 0.1
    reference = np.where(parted[..., None], other, mean)
    diff, se = compare.paired_difference(mean, reference)
    d = (mean.astype(np.float64) - reference).mean(axis=-1)
    assert diff == pytest.approx(d.mean()) and se == pytest.approx(d.std(ddof=1) / np.sqrt(d.size))
    assert se > 0.0 and abs(diff) <= compare.Z_MAX * se
    sdiff, sse = compare.paired_difference(1.02 * mean, reference)
    assert abs(sdiff) > compare.Z_MAX * sse
