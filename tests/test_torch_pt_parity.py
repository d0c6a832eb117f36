"""Parity of the PyTorch port's progressive path tracer with the JAX package
on the CPU: the direction samplers, the phase tables and inverse-CDF
sampling, Welford statistics, the tone map and golden-image comparison,
``render_subframe`` in all three modes (K4's plain version on the port's
side, the oracle loop ``march_deferred=False`` on the JAX side, whose
empty-cell jumps are off), ``render_tick``, Russian roulette, sky sampling,
the CI gate and ``ProgressiveRenderer``.

Inputs are made with numpy from fixed seeds and fed to both frameworks.
The scene: procedural cumulus 24^3 of seed 3, 600 m, 16 x 8 pixels, sample
step 1/64.  Stated tolerances:

- bitwise: the phase tables, the scene's path-tracer statics, the sun
  disc, the CI gate's count, ``to_uint8`` of one image;
- atol 1e-6: ``make_onb`` / ``from_onb`` / ``uniform_on_sphere_circle`` /
  ``new_direction`` and the two cos-theta samplers; rtol 1e-6: phase
  evaluation, the sky gradient, Welford update / merge, the tone map and
  RMS bias;
- single scatter and the first bounce (``max_depth`` 2): every pixel
  within 1e-5 of the image's largest value;
- deep paths (``max_depth`` 15, roulette, sky sampling): >= 98 % of pixels
  within a relative 1e-4 and the image mean within a relative 1e-4.
  JAX on the CPU and PyTorch round ``sin``, ``cos``, ``exp`` and ``log``
  differently in the last bit, and after a few bounces one ulp in a
  direction can move a threshold crossing by a step.  Measured on this
  scene: every pixel within a relative 1e-4, the largest difference
  2.2e-6 of the image's largest value;
- ticks (two of 5 subframes): counts and ``subframe_id`` equal; at
  ``max_depth`` 2 mean and m2 within 1e-5 of their largest values on every
  pixel (the port folds samples one by one, the JAX oracle tick takes the
  mean and squared deviations of a megabatch); at ``max_depth`` 15, for
  the ulp reason above, on >= 95 % of pixels, with the image means of mean
  and m2 within a relative 1e-4.  Measured: 97.7 % (m2) and 98.4 % (mean)
  of pixels in the all-scatter mode, 99.2 % in the multi-scatter mode; the
  largest difference 1.0e-4 of m2's largest value; image means within
  2.7e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepestscatter_tpu import scene as jscene
from deepestscatter_tpu.config import (
    CameraConfig,
    CloudModel,
    CloudRendering,
    ProgressiveConfig,
    RenderMode,
    SceneConfig,
)
from deepestscatter_tpu.data import procedural as jproc
from deepestscatter_tpu.ops import phase as jphase
from deepestscatter_tpu.ops import rng as jrng
from deepestscatter_tpu.ops import tonemap as jtone
from deepestscatter_tpu.ops import welford as jwel
from deepestscatter_tpu.render import camera as jcam
from deepestscatter_tpu.render import inscatter as jins
from deepestscatter_tpu.render import pathtracer as jpt
from deepestscatter_tpu.render import progressive as jprog
from deepestscatter_tpu.utils import compare as jcmp
from deepestscatter_tpu_torch import config as tconfig
from deepestscatter_tpu_torch import scene as tscene
from deepestscatter_tpu_torch.ops import phase as tphase
from deepestscatter_tpu_torch.ops import rng as trng
from deepestscatter_tpu_torch.ops import tonemap as ttone
from deepestscatter_tpu_torch.ops import welford as twel
from deepestscatter_tpu_torch.render import camera as tcam
from deepestscatter_tpu_torch.render import inscatter as tins
from deepestscatter_tpu_torch.render import pathtracer as tpt
from deepestscatter_tpu_torch.render import progressive as tprog
from deepestscatter_tpu_torch.utils import compare as tcmp
from deepestscatter_tpu_torch.utils import exr as texr

W, H = 16, 8
SEED = 7


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    # The frame's branch and its poles.
    v[:4] = [[0, 0, 1], [0, 0, -1], [0, 1, 0], [1e-4, 0, -0.99999994]]
    return v.astype(np.float32)


def test_onb_and_circle_sampler():
    rng = np.random.default_rng(1)
    n = _unit(rng, 512)
    local = rng.normal(size=(512, 3)).astype(np.float32)
    jt, jb = jrng.make_onb(jnp.asarray(n))
    tt, tb = trng.make_onb(torch.from_numpy(n))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        trng.from_onb(torch.from_numpy(local), torch.from_numpy(n)).numpy(),
        np.asarray(jrng.from_onb(jnp.asarray(local), jnp.asarray(n))),
        rtol=0, atol=1e-6,
    )
    u = rng.random(512).astype(np.float32)
    ct = rng.uniform(-1.0, 1.0, 512).astype(np.float32)
    np.testing.assert_allclose(
        trng.uniform_on_sphere_circle(torch.from_numpy(u), torch.from_numpy(ct)).numpy(),
        np.asarray(jrng.uniform_on_sphere_circle(jnp.asarray(u), jnp.asarray(ct))),
        rtol=0, atol=1e-6,
    )


def test_subframe_seed_schedule():
    subs = np.asarray([0, 1, 2, 77, 2**31 - 1], np.int64)
    for base in (0, 7, 2**32 - 1):
        ref = np.asarray(
            jnp.uint32(base) ^ (jnp.asarray(subs.astype(np.uint32)) * jnp.uint32(0x9E3779B1))
        ).astype(np.int64)
        np.testing.assert_array_equal(
            trng.subframe_seed(base, torch.from_numpy(subs)).numpy(), ref
        )
        assert [trng.subframe_seed(base, int(s)) for s in subs] == ref.tolist()


@pytest.fixture(scope="module")
def tables():
    return jphase.load_phase_table(), tphase.load_phase_table("cpu")


def test_phase_tables_bitwise(tables):
    jt, tt = tables
    for name in ("mie", "chopped", "chopped_cdf", "eval_rows", "inv_cdf_rows"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)))
    assert tt.inv_cdf_rows.shape == (16384, 2)


def test_eval_phase_and_cos_theta_samplers(tables):
    jt, tt = tables
    rng = np.random.default_rng(2)
    c = rng.uniform(-1.0, 1.0, 4096).astype(np.float32)
    c[:3] = (-1.0, 1.0, 0.0)
    for name in ("mie", "chopped"):
        np.testing.assert_allclose(
            tphase.eval_phase(getattr(tt, name), torch.from_numpy(c)).numpy(),
            np.asarray(jphase.eval_phase(getattr(jt, name), jnp.asarray(c))),
            rtol=1e-6, atol=0,
        )
    u = rng.random(4096).astype(np.float32)
    u[:4] = (0.0, 1e-9, 0.5, np.float32(1.0) - np.float32(2**-24))
    for tf, jf in (
        (tphase.sample_cos_theta, jphase.sample_cos_theta),
        (tphase.sample_cos_theta_fast, jphase.sample_cos_theta_fast),
    ):
        np.testing.assert_allclose(
            tf(tt, torch.from_numpy(u)).numpy(), np.asarray(jf(jt, jnp.asarray(u))),
            rtol=0, atol=1e-6,
        )


def test_new_direction(tables):
    jt, tt = tables
    rng = np.random.default_rng(3)
    d = _unit(rng, 1024)
    u1, u2 = rng.random((2, 1024)).astype(np.float32)
    jp = type("P", (), {"phase": jt})
    tp = type("P", (), {"phase": tt})
    ref = np.asarray(jpt.new_direction(jp, jnp.asarray(d), jnp.asarray(u1), jnp.asarray(u2)))
    got = tpt.new_direction(tp, torch.from_numpy(d), torch.from_numpy(u1), torch.from_numpy(u2))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)


def test_welford_update_merge_and_gate():
    rng = np.random.default_rng(4)
    xs = rng.gamma(1.5, 1.0, (6, 256)).astype(np.float32)
    mask = rng.random((6, 256)) < 0.8
    js = jwel.Welford(*(jnp.zeros(256, jnp.float32) for _ in range(3)))
    ts = twel.Welford(*(torch.zeros(256) for _ in range(3)))
    for x, m in zip(xs, mask):
        js = jwel.update(js, jnp.asarray(x), jnp.asarray(m))
        ts = twel.update(ts, torch.from_numpy(x), torch.from_numpy(m))
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    jm = jwel.merge(js, jwel.update(js, jnp.asarray(xs[0])))
    tm = twel.merge(ts, twel.update(ts, torch.from_numpy(xs[0])))
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    for a, b in zip(twel.from_moments(*twel.to_moments(tm)), jwel.from_moments(*jwel.to_moments(jm))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        twel.is_converged(tm, 0.3, 0.05).numpy(), np.asarray(jwel.is_converged(jm, 0.3, 0.05))
    )


def test_tonemap_and_compare(tmp_path):
    rng = np.random.default_rng(5)
    a = rng.gamma(0.8, 1.5, (H, W, 3)).astype(np.float32)
    b = (a * rng.uniform(0.8, 1.2, a.shape)).astype(np.float32)
    ref = np.array(jtone.reinhard(jnp.asarray(a), 0.4))
    got = ttone.reinhard(torch.from_numpy(a), 0.4).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        ttone.to_uint8(torch.from_numpy(ref)).numpy(), np.asarray(jtone.to_uint8(jnp.asarray(ref)))
    )
    assert tcmp.rms_bias(a, b) == pytest.approx(jcmp.rms_bias(a, b), rel=1e-6)
    np.testing.assert_allclose(tcmp.diff_image(a, b), jcmp.diff_image(a, b), rtol=0, atol=1e-6)
    texr.write_exr(str(tmp_path / "gt.PT.exr"), a)
    texr.write_exr(str(tmp_path / "nn.exr"), b)
    out_t = tcmp.compare_renders(str(tmp_path / "gt.PT.exr"), [str(tmp_path / "nn.exr")], str(tmp_path / "t"))
    out_j = jcmp.compare_renders(str(tmp_path / "gt.PT.exr"), [str(tmp_path / "nn.exr")])
    assert out_t.keys() == out_j.keys() == {"nn.exr"}
    assert out_t["nn.exr"] == pytest.approx(out_j["nn.exr"], rel=1e-6)
    assert (tmp_path / "t" / "nn.diff.exr").is_file()


def test_paint_error_pixels():
    x = np.asarray([[1.0, np.nan, 2.0], [np.inf, -np.inf, 0.5]], np.float32)
    np.testing.assert_array_equal(
        tprog.paint_error_pixels(torch.from_numpy(x)).numpy(),
        np.asarray(jprog.paint_error_pixels(jnp.asarray(x))),
    )


class Rig:
    """The 24^3 scene in both frameworks, baked by each; ``statics`` gives
    a mode / depth variant of both statics (the JAX one on its oracle loop
    without empty-cell jumps)."""

    def __init__(self, dt="float32", **rendering):
        kw = dict(max_depth=15, sample_step=1.0 / 64.0, march_dtype=dt, **rendering)
        jcfg = SceneConfig(
            cloud=CloudModel(size_m=600.0), camera=CameraConfig(width=W, height=H),
            rendering=CloudRendering(**kw),
        )
        tcfg = tconfig.SceneConfig(
            cloud=tconfig.CloudModel(size_m=600.0), camera=tconfig.CameraConfig(width=W, height=H),
            rendering=tconfig.CloudRendering(**kw),
        )
        self.jcfg, self.tcfg = jcfg, tcfg
        density = jproc.cumulus(resolution=24, seed=3)
        jp, js = jscene.build_scene(jcfg, density)
        tp, ts = tscene.build_scene(tcfg, density, device="cpu")
        self.jp = jins.with_baked_inscatter(jp, js)
        self.tp = tins.with_baked_inscatter(tp, ts, device="cpu")
        self.js = dataclasses.replace(js, march_deferred=False, march_empty_skip=False)
        self.ts = ts
        self.o, self.d = jcam.generate_rays(jcam.camera_basis(jcfg.camera), W, H)
        self.to = torch.from_numpy(np.array(self.o))
        self.td = torch.from_numpy(np.array(self.d))

    def statics(self, mode, max_depth):
        return (
            dataclasses.replace(self.js, mode=RenderMode[mode], max_depth=max_depth),
            dataclasses.replace(self.ts, mode=tconfig.RenderMode[mode], max_depth=max_depth),
        )

    def subframes(self, js, ts, sub=3):
        ref = np.asarray(jpt.render_subframe(self.jp, js, self.o, self.d, SEED, jnp.int32(sub)))
        got = tpt.render_subframe(self.tp, ts, self.to, self.td, SEED, sub, device="cpu").numpy()
        return ref, got


@pytest.fixture(scope="module")
def rig():
    return Rig()


def test_scene_path_tracer_statics(rig):
    for name in ("max_depth", "rr_start_depth", "rr_survival", "sample_sky",
                 "max_total_steps", "max_march_steps", "sun_cos_half_angle"):
        assert getattr(rig.ts, name) == getattr(rig.js, name), name
    for name, host in (("sky_intensity", "sky_rgb"), ("ground_intensity", "ground_rgb")):
        np.testing.assert_array_equal(getattr(rig.tp, name).numpy(), np.asarray(getattr(rig.jp, name)))
        np.testing.assert_array_equal(np.float32(getattr(rig.ts, host)), getattr(rig.tp, name).numpy())


def test_sun_disc_and_sky_gradient(rig):
    rng = np.random.default_rng(6)
    d = _unit(rng, 1024)
    # Directions around the sun (-light_dir), inside and outside its disc.
    sun = -np.asarray(rig.jp.light_dir)
    d[4:260] = sun + rng.normal(scale=0.01, size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    jd, td = jnp.asarray(d), torch.from_numpy(d)
    ref = np.asarray(jcam.sun_disc(rig.jp, rig.js, jd))
    assert 0 < np.count_nonzero(ref[:, 0]) < 256  # both sides of the rim
    np.testing.assert_array_equal(tcam.sun_disc(rig.tp, rig.ts, td).numpy(), ref)
    np.testing.assert_allclose(
        tcam.sky_gradient(rig.tp, td).numpy(),
        np.asarray(jcam.sky_gradient(rig.jp, jd)), rtol=1e-6, atol=0,
    )


def _assert_tight(ref, got):
    assert got.shape == ref.shape == (W * H, 3)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def _assert_deep(ref, got):
    assert got.shape == ref.shape == (W * H, 3)
    assert np.all(np.isfinite(got))
    rel = np.abs(got - ref).max(-1) / np.maximum(np.abs(ref).max(-1), 1e-3)
    assert np.mean(rel <= 1e-4) >= 0.98
    assert abs(got.mean() - ref.mean()) <= 1e-4 * abs(ref.mean())


@pytest.mark.parametrize(
    "mode, max_depth",
    [
        ("SUN_SINGLE_SCATTER", 15),
        ("SUN_AND_SKY_ALL_SCATTER", 2),
        ("SUN_MULTIPLE_SCATTER", 2),
        ("SUN_AND_SKY_ALL_SCATTER", 15),
        ("SUN_MULTIPLE_SCATTER", 15),
    ],
)
def test_render_subframe_matches_jax_oracle(rig, mode, max_depth):
    ref, got = rig.subframes(*rig.statics(mode, max_depth))
    assert ref.mean() > 0.01  # the scene scatters
    if mode == "SUN_SINGLE_SCATTER" or max_depth <= 2:
        _assert_tight(ref, got)
    else:
        _assert_deep(ref, got)


def test_render_subframe_uint8_scene():
    r = Rig("uint8")
    _assert_deep(*r.subframes(*r.statics("SUN_AND_SKY_ALL_SCATTER", 15), sub=5))


@pytest.mark.parametrize(
    "rendering",
    [dict(rr_start_depth=3, rr_survival=0.8), dict(sample_sky=True)],
    ids=["roulette", "sky"],
)
def test_roulette_and_sky_sampling_match_jax(rendering):
    r = Rig(**rendering)
    js, ts = r.statics("SUN_AND_SKY_ALL_SCATTER", 15)
    assert (ts.rr_start_depth, ts.sample_sky) == (js.rr_start_depth, js.sample_sky)
    ref, got = r.subframes(js, ts)
    _assert_deep(ref, got)
    # The branch changes the image: it is exercised, not inert.
    plain_js = dataclasses.replace(js, rr_start_depth=0, sample_sky=False)
    assert not np.array_equal(
        np.asarray(jpt.render_subframe(r.jp, plain_js, r.o, r.d, SEED, jnp.int32(3))), ref
    )


def _close(a, b, tol=1e-5, share=1.0):
    """``a`` within ``tol`` of ``b``'s largest value on ``share`` of the
    pixels (rows), and where that is not all of them, the image means
    within a relative 1e-4."""
    a, b = np.asarray(a), np.asarray(b)
    err = np.abs(a - b).reshape(b.shape[0], -1).max(-1)
    assert np.mean(err <= tol * (np.abs(b).max() + 1e-9)) >= share
    if share < 1.0:
        assert abs(a.mean() - b.mean()) <= 1e-4 * abs(b.mean())


@pytest.mark.parametrize("max_depth", [2, 15])
@pytest.mark.parametrize("mode", ["SUN_AND_SKY_ALL_SCATTER", "SUN_MULTIPLE_SCATTER"])
def test_render_tick_matches_jax(rig, mode, max_depth):
    js, ts = rig.statics(mode, max_depth)
    sj = jprog.init_state(W * H)
    st = tprog.init_state(W * H, device="cpu")
    for _ in range(2):
        sj = jprog.render_tick(rig.jp, js, rig.o, rig.d, sj, seed_base=SEED, n_subframes=5)
        st = tprog.render_tick(rig.tp, ts, rig.to, rig.td, st, seed_base=SEED, n_subframes=5, device="cpu")
    share = 1.0 if max_depth <= 2 else 0.95
    _close(st.mean.numpy(), sj.mean, share=share)
    _close(st.m2.numpy(), sj.m2, share=share)
    np.testing.assert_array_equal(st.count.numpy(), np.asarray(sj.count))
    assert st.subframe_id == int(sj.subframe_id) == 10


def test_unconverged_count_matches_jax(rig):
    """The CI gate on one state gives one count in both frameworks."""
    js, _ = rig.statics("SUN_AND_SKY_ALL_SCATTER", 15)
    sj = jprog.render_tick(rig.jp, js, rig.o, rig.d, jprog.init_state(W * H), seed_base=SEED, n_subframes=5)
    shared = tprog.ProgressiveState(
        torch.from_numpy(np.array(sj.mean)), torch.from_numpy(np.array(sj.m2)),
        torch.from_numpy(np.array(sj.count)), 5,
    )
    for rel, ab in ((0.3, 0.01), (0.02, 0.01), (1.0, 1e-4)):
        n_ref = int(jprog.unconverged_count(sj, ProgressiveConfig(rel_tol=rel, abs_tol=ab)))
        got = int(tprog.unconverged_count(shared, tconfig.ProgressiveConfig(rel_tol=rel, abs_tol=ab)))
        assert got == n_ref
    assert 0 < int(jprog.unconverged_count(sj, ProgressiveConfig(rel_tol=0.3, abs_tol=0.01))) < W * H


def test_tick_moments_are_the_subframes_folded(rig):
    """One tick's moments equal the Welford fold of the same subframes
    rendered one by one (the same per-sample values, another order)."""
    _, ts = rig.statics("SUN_AND_SKY_ALL_SCATTER", 15)
    mean, m2, cnt = tpt.trace_tick_moments(rig.tp, ts, rig.to, rig.td, SEED, 4, 3, device="cpu")
    w = twel.Welford(*(torch.zeros(W * H, 3) for _ in range(3)))
    for k in range(3):
        w = twel.update(w, tpt.render_subframe(rig.tp, ts, rig.to, rig.td, SEED, 5 + k, device="cpu"))
    _close(mean, w.mean, 1e-6)
    _close(m2, w.m2, 1e-5)
    np.testing.assert_array_equal(cnt.numpy(), 3.0)


def test_capped_samples_count_honestly(rig):
    """A sample cut at the step cap is folded as a truncated sample: every
    pixel's count is the number of samples it folded (all of them), its
    partial NEE energy is kept, and the CI gate runs on those counts."""
    _, ts = rig.statics("SUN_AND_SKY_ALL_SCATTER", 15)
    full = tpt.trace_tick_moments(rig.tp, ts, rig.to, rig.td, SEED, 0, 4, device="cpu")
    cut = tpt.trace_tick_moments(rig.tp, ts, rig.to, rig.td, SEED, 0, 4, device="cpu", max_steps=6)
    np.testing.assert_array_equal(cut[2].numpy(), 4.0)
    assert np.isfinite(cut[0].numpy()).all() and np.isfinite(cut[1].numpy()).all()
    assert 0.0 < cut[0].mean().item() < full[0].mean().item()
    st = tprog.ProgressiveState(cut[0], cut[1], cut[2][:, None], 4)
    assert 0 <= int(tprog.unconverged_count(st, tconfig.ProgressiveConfig())) <= W * H


def test_progressive_renderer_matches_jax(rig):
    js, ts = rig.statics("SUN_AND_SKY_ALL_SCATTER", 15)
    pcfg = dict(subframes_per_tick=2, min_subframes=4, max_subframes=8,
                max_unconverged_pixels=W * H + 1)
    jcfg = dataclasses.replace(rig.jcfg, progressive=ProgressiveConfig(**pcfg))
    tcfg = dataclasses.replace(rig.tcfg, progressive=tconfig.ProgressiveConfig(**pcfg))
    snaps = []
    jr = jprog.ProgressiveRenderer(jcfg, rig.jp, js, seed=SEED)
    tr = tprog.ProgressiveRenderer(tcfg, rig.tp, ts, seed=SEED, device="cpu",
                                   snapshot_fn=lambda sf, img: snaps.append(sf))
    assert tr.tick() == jr.tick() == W * H  # before min_subframes
    ref, got = jr.run(), tr.run()
    assert got.shape == ref.shape == (H, W, 3)
    assert tr.state.subframe_id == int(jr.state.subframe_id) == 4
    _close(got.reshape(-1, 3), ref.reshape(-1, 3), share=0.95)
    assert snaps == []  # snapshot_every 40
    disp = tr.display_image()
    assert disp.dtype == np.uint8 and disp.shape == (H, W, 3)
    assert np.abs(disp.astype(int) - jr.display_image().astype(int)).max() <= 1
