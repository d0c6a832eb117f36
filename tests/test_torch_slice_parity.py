"""Parity of the PyTorch port's neural-frame slice with the JAX package on
the CPU: the scene's textures, trilinear / mip sampling, the descriptor
(K2's plain version), the in-scatter bake (K3's plain version), the camera
march with NEE (K1's plain version), and the whole ``render_disney`` frame
on the same converted weights, for a float32 scene and a uint8 scene
(brick rows on the JAX side).  Also the port's frame schedule against its
megabatch render.

Stated tolerances: bitwise for the uint8 / float32 textures; atol 1e-6 for
trilinear / sample_mip; atol 1e-5 for the descriptor layers; the bake to
rtol 1e-5 before quantization, and after
``floor(T * 255) / 255`` within 1/255 on at most 0.1 % of voxels; the
march's total T to rtol 1e-5, scatter flags equal on >= 99.5 % of rays,
scatter positions within 1e-4 where flags agree; the frame to rtol 1e-3
on every pixel whose scatter flag agrees (differences allowed only where
a flag flipped, on at most 0.5 % of pixels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepestscatter_tpu import scene as jscene
from deepestscatter_tpu.config import CameraConfig, CloudModel, CloudRendering, SceneConfig
from deepestscatter_tpu.data import procedural as jproc
from deepestscatter_tpu.models.rpnn import DisneyModel as JaxDisneyModel
from deepestscatter_tpu.ops import descriptor as jdesc
from deepestscatter_tpu.ops import grid as jgrid
from deepestscatter_tpu.ops import march as jmarch
from deepestscatter_tpu.render import camera as jcam
from deepestscatter_tpu.render import inscatter as jins
from deepestscatter_tpu.render import neural as jneural
from deepestscatter_tpu.render import pathtracer as jpt
from deepestscatter_tpu_torch import config as tconfig
from deepestscatter_tpu_torch import scene as tscene
from deepestscatter_tpu_torch.models.convert import disney_from_flax
from deepestscatter_tpu_torch.models.rpnn import DisneyModel
from deepestscatter_tpu_torch.ops import descriptor as tdesc
from deepestscatter_tpu_torch.ops import grid as tgrid
from deepestscatter_tpu_torch.ops import march as tmarch
from deepestscatter_tpu_torch.render import camera as tcam
from deepestscatter_tpu_torch.render import inscatter as tins
from deepestscatter_tpu_torch.render import neural as tneural
from deepestscatter_tpu_torch.render import pathtracer as tpt

W, H = 24, 16
SEED = 3


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class Slice:
    """One scene in both frameworks, baked by each, with lazily computed
    (and cached) JAX results so the march and frame tests share them."""

    def __init__(self, dt):
        self.dt = dt
        jcfg = SceneConfig(
            cloud=CloudModel(size_m=1000.0),
            camera=CameraConfig(width=W, height=H),
            rendering=CloudRendering(march_dtype=dt),
        )
        tcfg = tconfig.SceneConfig(
            cloud=tconfig.CloudModel(size_m=1000.0),
            camera=tconfig.CameraConfig(width=W, height=H),
            rendering=tconfig.CloudRendering(march_dtype=dt),
        )
        self.tcfg = tcfg
        density = jproc.cumulus(resolution=24, seed=7)
        jp, self.js = jscene.build_scene(jcfg, density)
        tp, self.ts = tscene.build_scene(tcfg, density, device="cpu")
        self.raw = (
            np.asarray(jins.bake(jp, self.js, quantize=False)),
            tins.bake(tp, self.ts, quantize=False, device="cpu").numpy(),
        )
        self.jp = jins.with_baked_inscatter(jp, self.js)
        self.tp = tins.with_baked_inscatter(tp, self.ts, device="cpu")
        self.o, self.d = jcam.generate_rays(jcam.camera_basis(jcfg.camera), W, H)
        self.to, self.td = tcam.generate_rays(tcam.camera_basis(tcfg.camera), W, H, "cpu")
        self._cache = {}

    def jax_cs(self):
        if "cs" not in self._cache:
            hit, t_hit = jcam.intersect_box(self.o, self.d, self.js, self.jp.bbox_size)
            entry = self.o + self.d * t_hit[:, None] + 0.5 * self.jp.bbox_size
            ids = jnp.arange(self.o.shape[0], dtype=jnp.uint32)
            cs = jneural.conditional_scatter(
                self.jp, self.js, entry, self.d, hit, jnp.uint32(SEED), ids
            )
            self._cache["cs"] = (np.asarray(hit), cs)
        return self._cache["cs"]

    def torch_cs(self):
        hit, t_hit = tcam.intersect_box(self.to, self.td, self.ts, self.tp.bbox_size)
        entry = tcam.entry_points(self.to, self.td, t_hit, self.tp.bbox_size)
        ids = torch.arange(self.to.shape[0])
        return hit, tneural.conditional_scatter(
            self.tp, self.ts, entry, self.td, hit, SEED, ids
        )


@pytest.fixture(scope="module", params=["float32", "uint8"])
def sl(request):
    return Slice(request.param)


@pytest.fixture(scope="module")
def weights():
    jmodel = JaxDisneyModel()
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 10, 226)))
    tmodel = DisneyModel()
    tmodel.load_state_dict(disney_from_flax(jax.tree_util.tree_map(np.asarray, variables)))
    return jmodel, variables, tmodel.eval()


def test_scene_statics_and_textures_bitwise(sl):
    jp, js, tp, ts = sl.jp, sl.js, sl.tp, sl.ts
    assert ts.grid_shape == js.grid_shape
    assert ts.n_mips == js.n_mips
    assert ts.cloud_aabb == js.cloud_aabb
    assert ts.max_march_steps == js.max_march_steps
    assert ts.sun_solid_angle_ratio == js.sun_solid_angle_ratio
    for jm, tm in zip(jp.density_mips, tp.density_mips):
        ref = np.asarray(jm[..., 0])  # packed corner 0 is the voxel itself
        assert tm.numpy().dtype == ref.dtype
        np.testing.assert_array_equal(tm.numpy(), ref)
    np.testing.assert_array_equal(
        tp.mip_flat.numpy(),
        np.concatenate([np.asarray(m[..., 0]).reshape(-1) for m in jp.density_mips]),
    )
    for name in ("bbox_size", "light_dir", "light_radiance"):
        np.testing.assert_array_equal(
            getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        )


def test_sample_trilinear_and_mip(sl):
    jp, tp = sl.jp, sl.tp
    rng = np.random.default_rng(11)
    u = rng.uniform(-0.1, 1.1, (2048, 3)).astype(np.float32)
    ju, tu = jnp.asarray(u), torch.from_numpy(u)
    for jm, tm in zip(jp.density_mips[:3], tp.density_mips[:3]):
        np.testing.assert_allclose(
            tgrid.sample_trilinear(tm, tu).numpy(),
            np.asarray(jgrid.sample_trilinear(jm, ju)),
            rtol=0,
            atol=1e-6,
        )
    for lod in (0.0, 0.37, 1.0, 2.6, 40.0):
        np.testing.assert_allclose(
            tgrid.sample_mip(tp.density_mips, tu, lod).numpy(),
            np.asarray(jgrid.sample_mip(jp.density_mips, ju, lod)),
            rtol=0,
            atol=1e-6,
        )


def test_descriptor_layers_and_network_inputs(sl):
    """gather_descriptor, and K2's plain version (layers + omega in the
    [N, 10, 226] layout DisneyModel takes)."""
    jp, js, tp, ts = sl.jp, sl.js, sl.tp, sl.ts
    rng = np.random.default_rng(5)
    pos = rng.uniform(-0.05, 1.05, (96, 3)).astype(np.float32)
    view = rng.normal(size=(96, 3)).astype(np.float32)
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    jl = jdesc.gather_descriptor(jp, js, jnp.asarray(pos), jnp.asarray(view))
    ref = np.asarray(jl)
    tpos, tview = torch.from_numpy(pos), torch.from_numpy(view)
    got = tdesc.gather_descriptor(tp, ts, tpos, tview)
    assert got.shape == ref.shape == (96, 10, 225)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    ref_in = np.asarray(
        jdesc.with_angle(jl, jdesc.omega_angle(jp.light_dir, jnp.asarray(view)))
    )
    got_in = tdesc.network_inputs(tp, ts, tpos, tview)
    assert got_in.shape == (96, 10, 226)
    np.testing.assert_allclose(got_in.numpy(), ref_in, rtol=0, atol=1e-5)


def test_bake_matches_before_and_after_quantization(sl):
    jraw, traw = sl.raw
    np.testing.assert_allclose(traw, jraw, rtol=1e-5, atol=0)
    jq = np.floor(jraw * 255.0) / 255.0
    tq = np.floor(traw * 255.0) / 255.0
    off = np.abs(jq - tq)
    assert off.max() <= 1.0 / 255.0 + 1e-7
    assert np.count_nonzero(off) <= 1e-3 * off.size
    # The texture NEE samples: the same quantizers on both sides.
    jtex = np.asarray(sl.jp.inscatter[..., 0])
    assert sl.tp.inscatter.numpy().dtype == jtex.dtype
    np.testing.assert_array_equal(sl.tp.inscatter.numpy(), jtex)


def test_bake_without_early_out_matches(sl):
    ref = np.asarray(jins.bake(sl.jp, sl.js, quantize=False, early_out=False))
    got = tins.bake(sl.tp, sl.ts, quantize=False, early_out=False, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)


def test_baked_texture_is_the_floored_transmittance(sl):
    """The two quantizers compose exactly: the stored texture is
    ``floor(T * 255)`` (uint8) or ``floor(T * 255) / 255`` (float32)."""
    _, traw = sl.raw
    steps = np.floor(traw * np.float32(255.0))
    tex = sl.tp.inscatter.numpy()
    if sl.dt == "uint8":
        np.testing.assert_array_equal(tex.astype(np.float32), steps)
    else:
        np.testing.assert_array_equal(tex, steps / np.float32(255.0))


def test_rays_and_box_hits_match(sl):
    np.testing.assert_allclose(sl.td.numpy(), np.asarray(sl.d), rtol=0, atol=2e-7)
    hit, _ = jcam.intersect_box(sl.o, sl.d, sl.js, sl.jp.bbox_size)
    thit, _ = tcam.intersect_box(sl.to, sl.td, sl.ts, sl.tp.bbox_size)
    np.testing.assert_array_equal(thit.numpy(), np.asarray(hit))
    np.testing.assert_allclose(
        tcam.miss_radiance(sl.tp, sl.ts, sl.td).numpy(),
        np.asarray(jcam.miss_radiance(sl.jp, sl.js, sl.d)),
        rtol=1e-6,
    )


def test_march_and_nee_match_jax(sl):
    h, ref = sl.jax_cs()
    _, got = sl.torch_cs()
    np.testing.assert_allclose(
        got.transmittance.numpy()[h], np.asarray(ref.transmittance)[h], rtol=1e-5, atol=0
    )
    jf = np.asarray(ref.has_scattered)
    tf = got.has_scattered.numpy()
    assert jf.sum() > 20  # the scene scatters
    assert np.mean(jf == tf) >= 0.995
    agree = jf & tf
    np.testing.assert_allclose(
        got.scatter_pos.numpy()[agree], np.asarray(ref.scatter_pos)[agree], rtol=0, atol=1e-4
    )
    ref_direct = np.asarray(ref.direct)[agree]
    np.testing.assert_allclose(
        got.direct.numpy()[agree], ref_direct, rtol=1e-3, atol=1e-6 * np.abs(ref_direct).max()
    )


def test_in_scattering_matches(sl):
    rng = np.random.default_rng(21)
    pos = rng.uniform(0.0, 1.0, (256, 3)).astype(np.float32)
    view = rng.normal(size=(256, 3)).astype(np.float32)
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    ref = np.asarray(
        jpt.in_scattering(sl.jp, sl.js, jnp.asarray(pos), jnp.asarray(view), chopped=False)
    )
    got = tpt.in_scattering(sl.tp, sl.ts, torch.from_numpy(pos), torch.from_numpy(view))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6 * np.abs(ref).max())


def test_back_correct_distance():
    rng = np.random.default_rng(1)
    od = rng.uniform(0.0, 1.0, 512).astype(np.float32)
    t = rng.uniform(0.0, 1.0, 512).astype(np.float32)
    s = rng.uniform(0.0, 50.0, 512).astype(np.float32)
    od[:4] = (0.0, 1e-30, 0.5, 0.5)
    t[:4] = (0.5, 0.0, 0.0, 0.25)
    s[:4] = (1.0, 1.0, 0.0, 1e-12)
    ref = np.asarray(jmarch.back_correct_distance(jnp.asarray(od), jnp.asarray(t), jnp.asarray(s)))
    got = tmarch.back_correct_distance(torch.from_numpy(od), torch.from_numpy(t), torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)


def test_render_disney_matches_jax(sl, weights):
    jmodel, variables, tmodel = weights
    ref = np.asarray(
        jneural.render_disney(sl.jp, sl.js, jmodel, variables, sl.o, sl.d, seed=SEED)
    )
    got = tneural.render_disney(
        sl.tp, sl.ts, tmodel, sl.to, sl.td, seed=SEED, device="cpu"
    ).numpy()
    assert got.shape == ref.shape == (W * H, 3)
    assert np.all(np.isfinite(got))
    _, jcs = sl.jax_cs()
    _, tcs = sl.torch_cs()
    flipped = np.asarray(jcs.has_scattered) != tcs.has_scattered.numpy()
    assert flipped.mean() <= 0.005
    keep = ~flipped
    np.testing.assert_allclose(
        got[keep], ref[keep], rtol=1e-3, atol=1e-6 * np.abs(ref).max()
    )


def test_frame_matches_megabatch(sl, weights):
    """The port's version of test_disney_frame_matches_megabatch: the
    compacted, tiled frame schedule reproduces the megabatch render."""
    _, _, tmodel = weights
    direct = tneural.render_disney(
        sl.tp, sl.ts, tmodel, sl.to, sl.td, seed=SEED, device="cpu"
    )
    renderer = tneural.DisneyRenderer(tmodel, device="cpu")
    renderer.TILE = 64  # several shade tiles and a ragged tail
    basis = tcam.camera_basis(sl.tcfg.camera)
    frame = renderer.render_frame(sl.tp, sl.ts, W, H, basis, seed=SEED)
    assert frame.shape == (H, W, 3)
    np.testing.assert_allclose(
        frame.reshape(-1, 3).numpy(), direct.numpy(), rtol=2e-5, atol=1e-6
    )
    hit, cs = sl.torch_cs()
    n, n_hit, n_scat = renderer.last_counts
    assert (n, n_hit) == (W * H, int(hit.sum()))
    assert n_scat >= int(cs.has_scattered.sum()) > 0
    # Deterministic given the seed; another seed draws other scatter points.
    again = renderer.render_frame(sl.tp, sl.ts, W, H, basis, seed=SEED)
    other = renderer.render_frame(sl.tp, sl.ts, W, H, basis, seed=SEED + 1)
    assert torch.equal(frame, again)
    assert not torch.equal(frame, other)
