"""Parity of the PyTorch port's baked light-probe (BNN) slice with the JAX
package on the CPU: the tetrahedral probe interpolation (K5's plain
version), the alpha angle, the 3- and 9-layer descriptors (K2's plain
version with a frame direction), both probe models on converted Flax
weights, the probe bake, and the BNN frame, on the 1000 m cumulus scene of
``test_torch_slice_parity.py``.

Stated tolerances: tetrahedron selection equal on every point (random
points and points on the four test planes), corners equal, weights within
atol 1e-6; interpolated latents within atol 1e-6; omega, alpha and the
descriptor layers within atol 1e-5 (alpha modulo 2 pi at +-pi, where the
sign is the rounding of a zero triple product, and with two float32 ulps
of its cosine times acos' slope added there); the models within rtol 1e-5; the
baked uint8 probes within 1 on every entry and equal on >= 99.9 % of
entries (the latents within atol 1e-5 before quantization); the frames to
rtol 1e-3 on every pixel whose scatter flag agrees (flags may differ on at
most 0.5 % of pixels); the port's frame schedule against its own megabatch
render within rtol 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepestscatter_tpu import scene as jscene
from deepestscatter_tpu.config import CameraConfig, CloudModel, CloudRendering, SceneConfig
from deepestscatter_tpu.data import procedural as jproc
from deepestscatter_tpu.models.probes import LightProbeModel as JaxLightProbeModel
from deepestscatter_tpu.models.probes import ProbeRendererModel as JaxProbeRendererModel
from deepestscatter_tpu.ops import descriptor as jdesc
from deepestscatter_tpu.ops import tetra as jtetra
from deepestscatter_tpu.render import baked as jbaked
from deepestscatter_tpu.render import camera as jcam
from deepestscatter_tpu.render import inscatter as jins
from deepestscatter_tpu_torch import config as tconfig
from deepestscatter_tpu_torch import scene as tscene
from deepestscatter_tpu_torch.models.convert import light_probe_from_flax, probe_renderer_from_flax
from deepestscatter_tpu_torch.models.probes import LightProbeModel, ProbeRendererModel
from deepestscatter_tpu_torch.ops import descriptor as tdesc
from deepestscatter_tpu_torch.ops import tetra as ttetra
from deepestscatter_tpu_torch.render import baked as tbaked
from deepestscatter_tpu_torch.render import camera as tcam
from deepestscatter_tpu_torch.render import inscatter as tins
from deepestscatter_tpu_torch.render import neural as tneural

W, H = 24, 16
SEED = 5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class Scene:
    """The 1000 m cumulus (24^3, seed 7) in both frameworks, baked."""

    def __init__(self, dt):
        self.dt = dt
        jcfg = SceneConfig(
            cloud=CloudModel(size_m=1000.0),
            camera=CameraConfig(width=W, height=H),
            rendering=CloudRendering(march_dtype=dt),
        )
        self.tcfg = tconfig.SceneConfig(
            cloud=tconfig.CloudModel(size_m=1000.0),
            camera=tconfig.CameraConfig(width=W, height=H),
            rendering=tconfig.CloudRendering(march_dtype=dt),
        )
        density = jproc.cumulus(resolution=24, seed=7)
        jp, self.js = jscene.build_scene(jcfg, density)
        tp, self.ts = tscene.build_scene(self.tcfg, density, device="cpu")
        self.jp = jins.with_baked_inscatter(jp, self.js)
        self.tp = tins.with_baked_inscatter(tp, self.ts, device="cpu")
        self.o, self.d = jcam.generate_rays(jcam.camera_basis(jcfg.camera), W, H)
        self.to, self.td = tcam.generate_rays(tcam.camera_basis(self.tcfg.camera), W, H, "cpu")


_SCENES = {}


def _scene(dt):
    if dt not in _SCENES:
        _SCENES[dt] = Scene(dt)
    return _SCENES[dt]


@pytest.fixture(scope="module", params=["float32", "uint8"])
def sc(request):
    return _scene(request.param)


@pytest.fixture(scope="module")
def sc_u8():
    """The frame tests' scene: uint8 textures, as the BNN frame runs."""
    return _scene("uint8")


@pytest.fixture(scope="module")
def models():
    jprobe = JaxLightProbeModel()
    pvars = jprobe.init(jax.random.PRNGKey(1), jnp.zeros((1, 9, 225)))
    jrend = JaxProbeRendererModel()
    rvars = jrend.init(jax.random.PRNGKey(2), jnp.zeros((1, 202)), jnp.zeros((1, 3, 226)))
    tprobe = LightProbeModel()
    tprobe.load_state_dict(light_probe_from_flax(jax.tree_util.tree_map(np.asarray, pvars)))
    trend = ProbeRendererModel()
    trend.load_state_dict(probe_renderer_from_flax(jax.tree_util.tree_map(np.asarray, rvars)))
    return (jprobe, pvars, tprobe.eval()), (jrend, rvars, trend.eval())


def _views(n, seed):
    view = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return view / np.linalg.norm(view, axis=-1, keepdims=True)


def test_tetra_tables_match():
    np.testing.assert_array_equal(ttetra.TETRA_CORNERS, jtetra.TETRA_CORNERS)
    v = jnp.asarray(jtetra._TEST_VERTICES)
    normals = (jnp.float32(0.5) - v) / jnp.linalg.norm(
        jnp.float32(0.5) - v, axis=-1, keepdims=True
    )
    np.testing.assert_array_equal(ttetra.TEST_NORMALS, np.asarray(normals))
    assert ttetra.INV_SQRT3 == float(np.float32(jtetra._INV_SQRT3))


def _plane_points(n_per_plane, seed):
    """Local positions on each test plane (local - v) . n_v = 1/sqrt(3): for
    v = (0,0,0) the plane x + y + z = 1, and its mirror images for the
    other vertices; plus the cell's corners, centre and the planes'
    vertices."""
    rng = np.random.default_rng(seed)
    pts = []
    for v in jtetra._TEST_VERTICES:
        ab = rng.uniform(0.0, 1.0, (n_per_plane, 2)).astype(np.float32)
        ab = np.where(ab.sum(-1, keepdims=True) > 1.0, 1.0 - ab, ab)
        q = np.concatenate([ab, 1.0 - ab.sum(-1, keepdims=True)], axis=-1)  # x+y+z=1
        pts.append(np.where(v > 0, 1.0 - q, q))  # mirror the axes where v is 1
    special = [[0, 0, 0], [0.5, 0.5, 0.5], [1 / 3, 1 / 3, 1 / 3], [1, 0, 0], [0, 1, 0],
               [0, 0, 1], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5], [0.999999, 0, 0]]
    pts.append(np.asarray(special))
    return np.clip(np.concatenate(pts), 0.0, np.float32(1.0 - 2**-24)).astype(np.float32)


def test_probe_interpolation_matches():
    """Random lattice-unit positions (cells below 0 included) and points on
    the four test planes, in cells near the origin and far from it."""
    rng = np.random.default_rng(3)
    rand = rng.uniform(-2.0, 20.0, (4096, 3)).astype(np.float32)
    local = _plane_points(256, 4)
    cells = rng.integers(-1, 17, (local.shape[0], 3)).astype(np.float32)
    on_planes = np.concatenate([local, local + cells]).astype(np.float32)
    for units in (rand, on_planes):
        jc, jw = jtetra.probe_interpolation(jnp.asarray(units))
        tc, tw = ttetra.probe_interpolation(torch.from_numpy(units))
        cell = np.floor(units)
        np.testing.assert_array_equal(
            ttetra.select_tetrahedron(torch.from_numpy(units - cell)).numpy(),
            np.asarray(jtetra.select_tetrahedron(jnp.asarray(units - cell))),
        )
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    # Every tetrahedron is chosen somewhere.
    assert set(ttetra.select_tetrahedron(torch.from_numpy(local)).tolist()) == set(range(5))


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_interpolate_probes_matches(sc_u8, dtype):
    sc = sc_u8
    """K5's plain version: latents against ``interpolate_probes``, omega
    and alpha against ``omega_angle`` / ``alpha_canonical``; points from 5 %
    outside to 5 % beyond the box (corners clamped to the lattice)."""
    rng = np.random.default_rng(8)
    lattice = tbaked.probe_lattice_shape(sc.ts)
    shape = tuple(reversed(lattice)) + (200,)
    if dtype == "uint8":
        probes = rng.integers(0, 256, shape).astype(np.uint8)
    else:
        probes = rng.random(shape).astype(np.float32)
    pos = (rng.uniform(-0.05, 1.05, (512, 3)) * np.asarray(sc.ts.bbox)).astype(np.float32)
    view = _views(512, 9)
    ref = np.asarray(jbaked.interpolate_probes(jnp.asarray(probes), sc.js, jnp.asarray(pos)))
    got = tbaked.interpolate_probes(
        sc.tp, sc.ts, torch.from_numpy(probes), torch.from_numpy(pos), torch.from_numpy(view)
    ).numpy()
    assert got.shape == (512, 202)
    np.testing.assert_allclose(got[:, :200], ref, rtol=0, atol=1e-6)
    omega = np.asarray(jdesc.omega_angle(sc.jp.light_dir, jnp.asarray(view)))
    alpha = np.asarray(jbaked.alpha_canonical(sc.jp, jnp.asarray(view)))
    np.testing.assert_allclose(got[:, 200], omega, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[:, 201], alpha, rtol=0, atol=1e-5)


def test_alpha_angle_matches(sc_u8):
    sc = sc_u8
    """Random views, views along and near the probe direction and along the
    axes (both signs of alpha).  Views along the light are left out: their
    frame is the normalized rounding residue of a zero cross product in
    either framework."""
    view = _views(1024, 12)
    view[:8] = [[0, 0, 1], [0, 0, -1], [0.01, 0, 0.99995], [0, 0.01, -0.99995],
                [1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0]]
    probe = np.broadcast_to(np.asarray(tbaked.PROBE_DIRECTION, np.float32), view.shape)
    ref = np.asarray(jdesc.alpha_angle(sc.jp.light_dir, jnp.asarray(view), jnp.asarray(probe)))
    got = tdesc.alpha_angle(sc.tp.light_dir, torch.from_numpy(view), torch.from_numpy(probe.copy()))
    # Where eY_view = -eY_probe (alpha = +-pi) the sign is that of a zero
    # triple product's rounding: compare the angles modulo 2 pi there.
    # Near +-pi acos magnifies its argument's last bit by 1 / sin(alpha):
    # allow two float32 ulps of the cosine at that slope beyond 1e-5.
    wrapped = np.abs((got.numpy() - ref + np.pi) % (2.0 * np.pi) - np.pi)
    slope = 1.0 / np.sqrt(np.maximum(1.0 - np.cos(ref.astype(np.float64)) ** 2, 1e-12))
    assert np.all(wrapped <= 1e-5 + 2.4e-7 * slope)
    far = np.abs(got.numpy() - ref) > 1e-5
    assert np.all(np.abs(np.abs(ref[far]) - np.pi) <= 1e-2)
    assert (ref < 0).any() and (ref > 0).any()


@pytest.mark.parametrize("layers", ["realtime", "lightprobe"])
def test_descriptor_layers_match(sc, layers):
    """3 layers along the view (with omega: K2's [N, 3, 226]) and 9 layers
    in the probe direction's frame (the bake's)."""
    rng = np.random.default_rng(5)
    pos = (rng.uniform(-0.05, 1.05, (96, 3)) * np.asarray(sc.ts.bbox)).astype(np.float32)
    view = _views(96, 6)
    tpos, tview = torch.from_numpy(pos), torch.from_numpy(view)
    if layers == "realtime":
        n, frame = jdesc.BAKED_REALTIME_LAYERS, None
        assert n == tdesc.BAKED_REALTIME_LAYERS == 3
    else:
        n, frame = jdesc.LIGHTPROBE_LAYERS, np.broadcast_to(
            np.asarray(jbaked.PROBE_DIRECTION, np.float32), (96, 3)).copy()
        assert n == tdesc.LIGHTPROBE_LAYERS == 9
    jl = jdesc.gather_descriptor(
        sc.jp, sc.js, jnp.asarray(pos), jnp.asarray(view), n_layers=n,
        frame_dir=None if frame is None else jnp.asarray(frame),
    )
    tframe = None if frame is None else torch.from_numpy(frame)
    got = tdesc.gather_descriptor(sc.tp, sc.ts, tpos, tview, n, tframe)
    assert got.shape == (96, n, 225)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    ref_in = np.asarray(jdesc.with_angle(jl, jdesc.omega_angle(sc.jp.light_dir, jnp.asarray(view))))
    got_in = tdesc.network_inputs(sc.tp, sc.ts, tpos, tview, n, tframe)
    assert got_in.shape == (96, n, 226)
    np.testing.assert_allclose(got_in.numpy(), ref_in, rtol=0, atol=1e-5)


def test_models_match_on_converted_weights(models):
    (jprobe, pvars, tprobe), (jrend, rvars, trend) = models
    rng = np.random.default_rng(13)
    z = rng.random((64, 9, 225)).astype(np.float32)
    ref = np.asarray(jprobe.apply(pvars, jnp.asarray(z)))
    with torch.no_grad():
        got = tprobe(torch.from_numpy(z)).numpy()
    assert got.shape == (64, 200)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    probe_in = rng.random((64, 202)).astype(np.float32)
    desc = rng.random((64, 3, 226)).astype(np.float32)
    ref = np.asarray(jrend.apply(rvars, jnp.asarray(probe_in), jnp.asarray(desc)))
    with torch.no_grad():
        got = trend(torch.from_numpy(probe_in), torch.from_numpy(desc)).numpy()
    assert got.shape == (64, 1)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


def test_lattice_and_positions_match(sc_u8):
    sc = sc_u8
    lattice = tbaked.probe_lattice_shape(sc.ts)
    assert lattice == jbaked.probe_lattice_shape(sc.js, sc.jp.bbox_size.tolist()) == (18, 18, 18)
    np.testing.assert_array_equal(
        tbaked.probe_positions(sc.ts, (3, 4, 5), "cpu").numpy(),
        np.asarray(jbaked.probe_positions(sc.js, (3, 4, 5))),
    )


@pytest.fixture(scope="module")
def bake_pair(sc_u8, models):
    """A 6 x 5 x 7 corner of the lattice baked by both (chunks of 64 with a
    ragged tail), quantized and not."""
    (jprobe, pvars, tprobe), _ = models
    lattice = (6, 5, 7)
    out = {}
    for q in (True, False):
        ref = np.asarray(jbaked.bake_probes(sc_u8.jp, sc_u8.js, jprobe, pvars, lattice, chunk=64,
                                            quantize=q))
        got = tbaked.bake_probes(sc_u8.tp, sc_u8.ts, tprobe, lattice, chunk=64, quantize=q)
        out[q] = (ref, got.numpy())
    return out


def test_bake_probes_matches(bake_pair):
    ref, got = bake_pair[True]
    assert got.shape == ref.shape == (7, 5, 6, 200) and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert np.mean(diff == 0) >= 0.999
    ref_f, got_f = bake_pair[False]
    np.testing.assert_allclose(got_f, ref_f, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def flags(sc_u8, renderers, jax_frame):
    """Scatter flags of the frame's camera in both frameworks (JAX's from
    the compacted camera its frame ran, already compiled; the JAX package
    pins it to the megabatch camera)."""
    sc = sc_u8
    jr, _ = renderers
    ids = jnp.arange(sc.o.shape[0], dtype=jnp.uint32)
    jcs, _, _ = jr._camera.run(sc.jp, sc.js, sc.o, sc.d, jnp.uint32(SEED), ids)
    thit, tt = tcam.intersect_box(sc.to, sc.td, sc.ts, sc.tp.bbox_size)
    tentry = tcam.entry_points(sc.to, sc.td, tt, sc.tp.bbox_size)
    tcs = tneural.conditional_scatter(sc.tp, sc.ts, tentry, sc.td, thit, SEED,
                                      torch.arange(sc.to.shape[0]))
    return np.asarray(jcs.has_scattered), tcs.has_scattered.numpy()


def _assert_frames_agree(got, ref, flags):
    assert got.shape == ref.shape == (W * H, 3)
    assert np.all(np.isfinite(got))
    jf, tf = flags
    assert jf.sum() > 20
    flipped = jf != tf
    assert flipped.mean() <= 0.005
    np.testing.assert_allclose(got[~flipped], ref[~flipped], rtol=1e-3,
                               atol=1e-6 * np.abs(ref).max())


@pytest.fixture(scope="module")
def renderers(sc_u8, models):
    (jprobe, pvars, tprobe), (jrend, rvars, trend) = models
    jr = jbaked.BakedRenderer(sc_u8.jp, sc_u8.js, jprobe, pvars, jrend, rvars)
    tr = tbaked.BakedRenderer(sc_u8.tp, sc_u8.ts, tprobe, trend, device="cpu")
    return jr, tr


@pytest.fixture(scope="module")
def jax_frame(sc_u8, renderers):
    """JAX's BNN frame: ``BakedRenderer.render_frame``, which the JAX
    package's own test pins to its ``render_baked`` within rtol 2e-5."""
    jr, _ = renderers
    basis = jcam.camera_basis(SceneConfig(camera=CameraConfig(width=W, height=H)).camera)
    return np.asarray(jr.render_frame(sc_u8.jp, sc_u8.js, W, H, basis, seed=SEED)).reshape(-1, 3)


def test_render_baked_matches_jax(sc_u8, models, renderers, flags, jax_frame):
    """The port's megabatch render on JAX's probes against JAX's frame."""
    _, (_, _, trend) = models
    jr, _ = renderers
    got = tbaked.render_baked(sc_u8.tp, sc_u8.ts, trend, torch.from_numpy(np.array(jr.probes)),
                              sc_u8.to, sc_u8.td, seed=SEED, device="cpu").numpy()
    _assert_frames_agree(got, jax_frame, flags)


def test_baked_renderer_frame_matches_jax(sc_u8, renderers, flags, jax_frame):
    """Each framework bakes its own lattice (35 x 35 x 35 at the chip's
    scene; 18^3 here) and renders the frame."""
    jr, tr = renderers
    assert tr.lattice == jr.lattice and tuple(tr.probes.shape) == jr.probes.shape
    diff = np.abs(tr.probes.numpy().astype(np.int32) - np.asarray(jr.probes).astype(np.int32))
    assert diff.max() <= 1 and np.mean(diff == 0) >= 0.999
    got = tr.render_frame(sc_u8.tp, sc_u8.ts, W, H, tcam.camera_basis(sc_u8.tcfg.camera),
                          seed=SEED).numpy()
    _assert_frames_agree(got.reshape(-1, 3), jax_frame, flags)


def test_frame_matches_megabatch(sc_u8, renderers):
    """The port's version of test_baked_frame_matches_megabatch: the
    compacted, tiled frame schedule reproduces the megabatch render."""
    _, tr = renderers
    direct = tbaked.render_baked(sc_u8.tp, sc_u8.ts, tr.renderer_model, tr.probes,
                                 sc_u8.to, sc_u8.td, seed=SEED, device="cpu")
    tr.TILE = 64  # several shade tiles and a ragged tail
    basis = tcam.camera_basis(sc_u8.tcfg.camera)
    frame = tr.render_frame(sc_u8.tp, sc_u8.ts, W, H, basis, seed=SEED)
    assert frame.shape == (H, W, 3)
    np.testing.assert_allclose(frame.reshape(-1, 3).numpy(), direct.numpy(), rtol=2e-5, atol=1e-6)
    n, n_hit, n_scat = tr.last_counts
    assert n == W * H and n_scat > 0
    again = tr.render_frame(sc_u8.tp, sc_u8.ts, W, H, basis, seed=SEED)
    other = tr.render_frame(sc_u8.tp, sc_u8.ts, W, H, basis, seed=SEED + 1)
    assert torch.equal(frame, again)
    assert not torch.equal(frame, other)
