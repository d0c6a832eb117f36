"""Parity of the port's differentiable multi-scatter renderer
(``deepestscatter_tpu_torch.render.diff.render_multi_scatter_mc`` and
``multi_scatter_and_grads``) with the JAX package's on the CPU, where the
port runs its plain versions on autograd (the plain bake, and
``scatter_loop_plain`` rematerialized in chunks of iterations).

The scenes and arguments are ``tests/test_diff_cross_validation.py``'s: the
16^3 thin cloud at 400 m (density multiplier 40), step 1/64, sun (-0.3,
-0.9, 0.1), eye (2.5, -0.4, 0), light 1e6, ``SUN_AND_SKY_ALL_SCATTER``.  The
JAX functions run once a point, in module fixtures.

- The forward image at 24 x 12, ``max_depth`` 4, 2 subframes, seed 9
  against JAX's within rtol 1e-4, atol 1e-5 (JAX's own test against its
  path tracer), and against the port's own ``render_subframe`` average at
  the same tolerance.
- The gradients at 12 x 8, ``max_depth`` 3, 2 subframes, seed 4: every
  leaf finite and within 1e-4 of the largest |value| of JAX's; density and
  sun direction nonzero.  Not bitwise: the exponentials and logarithms of
  XLA and PyTorch on the CPU differ in the last bit, and JAX samples the
  raw grid through its 8-gather path (another lerp order).
- JAX's central-difference checks (``test_diff_cross_validation.py:
  184-214``) on the port: the density voxel of the largest gradient at eps
  1e-3 and 3e-4 (rtol 5e-2), sun_dir[1] at 1e-3, 3e-4 and 1e-4 (rtol
  8e-2).
- Axis-parallel rays (an eye on the x axis) give finite gradients.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepestscatter_tpu import config as jconfig
from deepestscatter_tpu.ops import grid as jgrid
from deepestscatter_tpu.render import diff as jdiff
from deepestscatter_tpu_torch import config as tconfig
from deepestscatter_tpu_torch.render import diff as tdiff
from deepestscatter_tpu_torch.render import pathtracer as tpt

LEAF_TOL = 1e-4
#: test_diff_cross_validation.py's forward point and its gradients' point.
IMAGE_KW = dict(width=24, height=12, max_depth=4, n_subframes=2, seed=9)
GRAD_KW = dict(width=12, height=8, max_depth=3, n_subframes=2, seed=4)
SUN = (-0.3, -0.9, 0.1)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _leaves(eye=(2.5, -0.4, 0.0)):
    rng = np.random.default_rng(0)
    d = np.zeros((16, 16, 16), np.float32)
    d[3:-3, 3:-3, 3:-3] = rng.random((10,) * 3).astype(np.float32)
    return (np.asarray(jgrid.normalize_density(d)), np.asarray(SUN, np.float32),
            np.asarray(eye, np.float32), np.zeros(3, np.float32), np.full(3, 1e6, np.float32))


def _cfg(mod, **extra):
    return mod.SceneConfig(
        cloud=mod.CloudModel(size_m=400.0),
        light=mod.DirectionalLight(direction=SUN),
        camera=mod.CameraConfig(width=24, height=12),
        rendering=mod.CloudRendering(sample_step=1.0 / 64.0, max_depth=4,
                                     mode=mod.RenderMode.SUN_AND_SKY_ALL_SCATTER, **extra),
    )


def _jax_scene(leaves):
    return jdiff.DiffScene(*map(jnp.asarray, leaves))


def _port_scene(leaves):
    return tdiff.diff_scene_from_numpy(*leaves, device="cpu")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert scale > 0
    return float(np.abs(got - want).max() / scale)


@pytest.fixture(scope="module")
def images():
    leaves = _leaves()
    want = np.asarray(jdiff.render_multi_scatter_mc(
        _jax_scene(leaves), _cfg(jconfig, march_deferred=False), **IMAGE_KW))
    with torch.no_grad():
        got = tdiff.render_multi_scatter_mc(_port_scene(leaves), _cfg(tconfig), device="cpu",
                                            **IMAGE_KW)
    return leaves, got.numpy(), want


def test_image_matches_jax(images):
    _, got, want = images
    assert got.shape == want.shape == (12, 24, 3)
    assert np.isfinite(got).all() and (got > 0).mean() > 0.5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_image_is_the_path_tracers_subframe_mean(images):
    """The same params through ``render_subframe``, subframes 1 and 2."""
    leaves, got, _ = images
    scene = _port_scene(leaves)
    with torch.no_grad():
        params, static = tdiff.diff_scene(_cfg(tconfig), scene, max_depth=IMAGE_KW["max_depth"])
        o, d = tdiff.camera_rays(scene.eye, scene.look_at, IMAGE_KW["width"],
                                 IMAGE_KW["height"])
        acc = torch.zeros_like(o)
        for s in range(2):
            acc = acc + tpt.render_subframe(params, static, o, d, IMAGE_KW["seed"], s + 1,
                                            device="cpu")
    np.testing.assert_allclose(got, (acc / 2).reshape(12, 24, 3).numpy(), rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def grads():
    leaves = _leaves()
    jimg, jg = jdiff.multi_scatter_and_grads(_jax_scene(leaves),
                                             _cfg(jconfig, march_deferred=False), **GRAD_KW)
    scene = _port_scene(leaves)
    timg, tg = tdiff.multi_scatter_and_grads(scene, _cfg(tconfig), device="cpu", **GRAD_KW)
    return scene, (np.asarray(jimg), jg), (timg, tg)


def test_gradient_image_matches_jax(grads):
    _, (jimg, _), (timg, _) = grads
    np.testing.assert_allclose(timg.numpy(), jimg, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("leaf", tdiff.DiffScene._fields)
def test_gradients_match_jax(grads, leaf):
    _, (_, jg), (_, tg) = grads
    got = getattr(tg, leaf).numpy()
    assert np.isfinite(got).all()
    err = _rel(got, getattr(jg, leaf))
    assert err <= LEAF_TOL, f"{leaf}: {err:.3g} of JAX's largest value (tol {LEAF_TOL:g})"
    if leaf in ("density", "sun_dir"):
        assert float(np.abs(got).max()) > 0


# -- test_diff_cross_validation.py's central differences on the port ---------


def _loss(scene) -> float:
    with torch.no_grad():
        return float(tdiff.render_multi_scatter_mc(scene, _cfg(tconfig), device="cpu",
                                                   **GRAD_KW).mean())


def _fd(scene, set_, eps_list, analytic, rtol):
    errs = []
    for e in eps_list:
        fd = (_loss(set_(scene, +e)) - _loss(set_(scene, -e))) / (2 * e)
        if fd == pytest.approx(analytic, rel=rtol, abs=1e-7):
            return
        errs.append((e, fd))
    raise AssertionError(f"analytic {analytic} vs FD {errs}")


def _add(t, idx, d):
    t = t.clone()
    t[idx] += d
    return t


def test_density_gradient_matches_central_differences(grads):
    scene, _, (_, tg) = grads
    g = tg.density
    z, y, x = np.unravel_index(int(g.abs().argmax()), g.shape)
    _fd(scene, lambda s, d: s._replace(density=_add(s.density, (z, y, x), d)), [1e-3, 3e-4],
        float(g[z, y, x]), 5e-2)


def test_sun_gradient_matches_central_differences(grads):
    scene, _, (_, tg) = grads
    _fd(scene, lambda s, d: s._replace(sun_dir=_add(s.sun_dir, 1, d)), [1e-3, 3e-4, 1e-4],
        float(tg.sun_dir[1]), 8e-2)


def test_axis_parallel_rays_give_finite_gradients():
    """An eye on the x axis looking at the origin: the centre pixel's ray
    has exactly zero y and z components (the 1e-9 nudge before the box
    test's reciprocal)."""
    scene = _port_scene(_leaves(eye=(2.5, 0.0, 0.0)))
    _, dirs = tdiff.camera_rays(scene.eye, scene.look_at, GRAD_KW["width"], GRAD_KW["height"])
    assert bool(((dirs[:, 1] == 0) & (dirs[:, 2] == 0)).any())
    img, g = tdiff.multi_scatter_and_grads(scene, _cfg(tconfig), device="cpu", **GRAD_KW)
    assert bool(torch.isfinite(img).all()) and float(img.max()) > 0
    for leaf in g:
        assert bool(torch.isfinite(leaf).all())
    assert float(g.density.abs().max()) > 0
