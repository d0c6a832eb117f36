"""Parity of the port's differentiable single-scatter renderer
(``deepestscatter_tpu_torch.render.diff``) with the JAX package's
(``deepestscatter_tpu.render.diff``) on the CPU, where the port runs its
plain versions on autograd.

The same numpy inputs go to both.  Tolerances, each relative to the JAX
value's largest magnitude: the image 1e-5, the density gradient 1e-5, the
sun direction, eye, look-at and light radiance gradients 1e-4.  They are
tolerances, not bitwise: JAX's ``sample_density`` samples the raw grid
through its 8-gather path (``ops/grid.py:174-217``: lerps in another
order, and below the first texel centre a fraction that weights one texel
twice), the port's ``sample_trilinear`` through the packed path's weights
(fraction 0 there); values agree to an ulp, and the exponentials of XLA
and PyTorch on the CPU differ in the last bit.

Also: the bake against JAX's and bitwise against
``render.inscatter.sun_transmittance_plain(early_out=False)``; the sun
march against JAX's; the finite-difference checks of
``tests/test_diff_render.py`` on the port (same eps and rtol); finite
gradients for axis-parallel rays; ``remat_chunk`` changing nothing.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepestscatter_tpu.ops import grid as jgrid
from deepestscatter_tpu.render import diff as jdiff
from deepestscatter_tpu_torch import build_scene, config
from deepestscatter_tpu_torch.render import diff as tdiff
from deepestscatter_tpu_torch.render import inscatter

IMAGE_TOL = 1e-5
DENSITY_TOL = 1e-5
LEAF_TOL = 1e-4

#: tests/test_diff_render.py's scene and arguments (the pointwise sun march).
KW = dict(
    width=12, height=8, density_multiplier=40.0,
    n_steps=64, sun_steps=48, sample_step=1.0 / 64.0, remat_chunk=16,
    use_baked_inscatter=False,
)
#: tests/test_diff_cross_validation.py's quadrature (the baked in-scatter).
XVAL_KW = dict(width=24, height=12, density_multiplier=40.0, n_steps=128,
               sample_step=1.0 / 64.0)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _kw_scene(res=8):
    rng = np.random.default_rng(0)
    density = np.zeros((res, res, res), np.float32)
    density[2:-2, 2:-2, 2:-2] = rng.random((res - 4,) * 3).astype(np.float32)
    return (density, np.asarray([-0.3, -0.9, 0.1], np.float32),
            np.asarray([2.0, -0.3, 0.0], np.float32), np.zeros(3, np.float32),
            np.full(3, 1e6, np.float32))


def _xval_scene():
    rng = np.random.default_rng(0)
    d = np.zeros((16, 16, 16), np.float32)
    d[3:-3, 3:-3, 3:-3] = rng.random((10,) * 3).astype(np.float32)
    return (jgrid.normalize_density(d), np.asarray([-0.3, -0.9, 0.1], np.float32),
            np.asarray([2.5, -0.4, 0.0], np.float32), np.zeros(3, np.float32),
            np.full(3, 1e6, np.float32))


def _port(leaves):
    return tdiff.diff_scene_from_numpy(*leaves, device="cpu")


def _assert_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert scale > 0, what
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: {err:.3g} of its largest value (tol {tol:g})"


@pytest.fixture(scope="module", params=["pointwise", "baked"])
def both(request):
    """(leaves, kw, JAX (image, grads), port (image, grads)) at KW and at
    the cross-validation scene."""
    leaves, kw = (_kw_scene(), KW) if request.param == "pointwise" else (_xval_scene(), XVAL_KW)
    jimg, jg = jdiff.render_and_grads(jdiff.DiffScene(*map(jnp.asarray, leaves)), **kw)
    timg, tg = tdiff.render_and_grads(_port(leaves), device="cpu", **kw)
    return leaves, kw, (np.asarray(jimg), jg), (timg.numpy(), tg)


def test_image_matches_jax(both):
    _, _, (jimg, _), (timg, _) = both
    assert timg.shape == jimg.shape and np.isfinite(timg).all()
    assert (timg > 0).sum() > 50
    _assert_close(timg, jimg, IMAGE_TOL, "image")


@pytest.mark.parametrize("leaf", tdiff.DiffScene._fields)
def test_gradients_match_jax(both, leaf):
    _, _, (_, jg), (_, tg) = both
    got = getattr(tg, leaf).numpy()
    assert np.isfinite(got).all()
    _assert_close(got, np.asarray(getattr(jg, leaf)),
                  DENSITY_TOL if leaf == "density" else LEAF_TOL, leaf)


def test_bake_matches_jax_and_the_inscatter_bake():
    """The differentiable bake against JAX's (packed-corner sampling, the
    port's rule) and bitwise against the scene bake's exact mode."""
    density = _xval_scene()[0]
    cfg = config.SceneConfig(
        cloud=config.CloudModel(size_m=400.0),
        light=config.DirectionalLight(direction=(-0.3, -0.9, 0.1)),
        rendering=config.CloudRendering(sample_step=1.0 / 64.0),
    )
    params, static = build_scene(cfg, density, device="cpu")
    ref = inscatter.sun_transmittance_plain(params, static, early_out=False)
    got = tdiff.bake_inscatter_diff(params.density_mips[0], params.bbox_size, params.light_dir,
                                    static.density_multiplier, static.sample_step, device="cpu")
    assert torch.equal(got.reshape(-1), ref)
    jax_bake = jdiff.bake_inscatter_diff(
        jgrid.pack_corners(jnp.asarray(density)), jnp.asarray(params.bbox_size.numpy()),
        jnp.asarray(params.light_dir.numpy()), static.density_multiplier, static.sample_step)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_bake), rtol=0, atol=1e-6)


def test_sun_transmittance_matches_jax():
    density, sun = _kw_scene()[:2]
    pos = np.random.default_rng(3).uniform(0.0, 1.0, (64, 3)).astype(np.float32)
    want = np.asarray(jdiff.sun_transmittance(jnp.asarray(density), jnp.asarray(sun),
                                              jnp.asarray(pos), 40.0, 48, 1.0 / 64.0))
    got = tdiff.sun_transmittance(torch.from_numpy(density), torch.from_numpy(sun),
                                  torch.from_numpy(pos), 40.0, 48, 1.0 / 64.0, device="cpu")
    assert (want < 0.99).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# -- tests/test_diff_render.py's finite-difference checks on the port ---------


@pytest.fixture(scope="module")
def port_grads():
    scene = _port(_kw_scene())
    return scene, tdiff.render_and_grads(scene, device="cpu", **KW)[1]


def _loss(scene):
    with torch.no_grad():
        return float(tdiff.render_single_scatter(scene, device="cpu", **KW).mean())


def _fd_check(scene, analytic, set_, eps, rtol):
    errs = []
    for e in eps if isinstance(eps, (list, tuple)) else [eps]:
        g_fd = (_loss(set_(scene, +e)) - _loss(set_(scene, -e))) / (2 * e)
        if g_fd == pytest.approx(analytic, rel=rtol, abs=1e-7):
            return
        errs.append((e, g_fd))
    raise AssertionError(f"analytic {analytic} vs FD {errs}")


def _add(t, idx, d):
    t = t.clone()
    t[idx] += d
    return t


def test_fd_grad_wrt_density_voxel(port_grads):
    scene, g = port_grads
    z, y, x = np.unravel_index(int(g.density.abs().argmax()), g.density.shape)
    _fd_check(scene, float(g.density[z, y, x]),
              lambda s, d: s._replace(density=_add(s.density, (z, y, x), d)), 1e-3, 2e-2)


def test_fd_grad_wrt_sun_direction(port_grads):
    scene, g = port_grads
    _fd_check(scene, float(g.sun_dir[1]),
              lambda s, d: s._replace(sun_dir=_add(s.sun_dir, 1, d)), [1e-3, 3e-5, 1e-5], 5e-2)


def test_fd_grad_wrt_camera_eye(port_grads):
    scene, g = port_grads
    _fd_check(scene, float(g.eye[0]),
              lambda s, d: s._replace(eye=_add(s.eye, 0, d)), [1e-3, 1e-4, 3e-5], 5e-2)


# -- hazards --------------------------------------------------------------------


@pytest.mark.parametrize("baked", [False, True], ids=["pointwise", "baked"])
def test_axis_parallel_rays_give_finite_gradients(baked):
    """An eye on the x axis looking at the origin: the centre pixel's ray
    has exactly zero y and z components (the guarded reciprocal)."""
    leaves = list(_kw_scene())
    leaves[2] = np.asarray([2.0, 0.0, 0.0], np.float32)
    scene = _port(leaves)
    _, dirs = tdiff.camera_rays(scene.eye, scene.look_at, KW["width"], KW["height"])
    assert ((dirs[:, 1] == 0) & (dirs[:, 2] == 0)).any()
    img, g = tdiff.render_and_grads(scene, device="cpu", **dict(KW, use_baked_inscatter=baked))
    assert torch.isfinite(img).all() and float(img.max()) > 0
    for leaf in g:
        assert torch.isfinite(leaf).all()


def test_remat_chunk_changes_nothing():
    """remat_chunk sets what the backward pass recomputes, not the values
    (chunks that divide n_steps: the march runs whole chunks)."""
    scene = _port(_kw_scene())
    ref_img, ref_g = tdiff.render_and_grads(scene, device="cpu", **KW)
    for chunk in (8, 64):
        img, g = tdiff.render_and_grads(scene, device="cpu", **dict(KW, remat_chunk=chunk))
        assert torch.equal(img, ref_img)
        for a, b in zip(g, ref_g):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))


def test_sun_ratio_and_phase_follow_jax():
    """The per-ray factor: the phase at the angle to the sun times the sun
    disc's share of the sphere, as JAX forms it."""
    scene = _port(_kw_scene())
    m = tdiff.march_setup(scene, KW["width"], KW["height"], 40.0, 64, 48, 1.0 / 64.0,
                          math.cos(math.radians(0.53) / 2.0), 16, False, kernels=False)
    ratio = 2.0 * math.pi * (1.0 - math.cos(math.radians(0.53) / 2.0)) / (4.0 * math.pi)
    assert m.meta.sun_ratio == float(np.float32(ratio))
    assert m.meta.n_steps == 64 and bool(m.hit.any())
    assert float(m.p_phase.min()) > 0
