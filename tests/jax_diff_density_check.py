"""The density gradient of the differentiable single-scatter render at
``chip_smoke.py``'s defaults point, on the CPU: the JAX package's against
the port's, and both against a float64 witness.

The defaults point is ``render_single_scatter``'s own defaults (64 x 32,
256 steps of 1/256, density multiplier 100, baked in-scatter) on EVAL_r05's
held-out cloud ``procedural:64:29``, normalised and unpadded, with
``tests/test_diff_cross_validation.py``'s sun, eye and light.  The port's
plain bake (``bake_inscatter_diff_plain``) sums its steps' density
gradients in float64; the JAX bake (a float32 ``lax.scan`` under
``jax.checkpoint``) sums them in float32.  A texel on the box's faces takes
the clamped samples of every march that leaves across it, so the two
differ there.  The witness isolates the bake: the same upstream gradient
of the baked grid (the port's plain march adjoint of the image mean) goes
into JAX's bake (``jax.vjp``), the port's plain bake (autograd) and the
bake evaluated in float64 throughout (positions, samples, exponentials,
sums).  Each density gradient is held against the witness's, relative to
the witness's largest value; so is each full render's density gradient
(the bake's part plus the march's own, the latter the port's in both
witness terms).  Prints one JSON line; about five minutes on the CPU.

    JAX_PLATFORMS=cpu python tests/jax_diff_density_check.py
"""

from __future__ import annotations

import functools
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CLOUD = (64, 29)
SUN = (-0.3, -0.9, 0.1)
EYE = (2.5, -0.4, 0.0)
RADIANCE = 1e6


def bake64(density, light_dir, density_multiplier, sample_step, n_steps):
    """The differentiable bake in float64 throughout → T [V]."""
    import torch
    from torch.utils.checkpoint import checkpoint

    from deepestscatter_tpu_torch.ops import grid as grid_ops
    from deepestscatter_tpu_torch.render import inscatter

    base = inscatter.voxel_base(density.shape, density.device).to(torch.float64)
    bbox = torch.tensor([float(v) for v in grid_ops.bbox_size_from_shape(density.shape)],
                        dtype=torch.float64)

    def body(trans, dens, tl, s):
        sigma = grid_ops.sample_trilinear(dens, (base + tl * s) / bbox)
        return trans * torch.exp(-(sigma * density_multiplier) * sample_step)

    trans = torch.ones(base.shape[:1], dtype=torch.float64)
    for i in range(n_steps):
        trans = checkpoint(functools.partial(body, s=sample_step * i), trans, density,
                           -light_dir, use_reentrant=False)
    return trans


def rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def main() -> int:
    import jax
    import jax.numpy as jnp
    import torch

    from deepestscatter_tpu.ops import grid as jgrid
    from deepestscatter_tpu.render import diff as jdiff
    from deepestscatter_tpu_torch.data import procedural
    from deepestscatter_tpu_torch.ops import grid as grid_ops
    from deepestscatter_tpu_torch.render import diff as tdiff
    from deepestscatter_tpu_torch.render import inscatter

    t_start = time.time()
    density = grid_ops.normalize_density(procedural.cumulus(resolution=CLOUD[0], seed=CLOUD[1]))
    leaves = (density, np.asarray(SUN, np.float32), np.asarray(EYE, np.float32),
              np.zeros(3, np.float32), np.full(3, RADIANCE, np.float32))
    # Every default but the sun's half-angle, which each render takes as its
    # own default: given explicitly, JAX's jit traces it as a float32 and
    # 1 - cos(0.265 deg) loses 0.25 % of the sun's solid angle.
    kw = {k: p.default for k, p in
          __import__("inspect").signature(tdiff.render_single_scatter).parameters.items()
          if k not in ("scene", "device", "sun_cos_half_angle")}

    # The whole render's density gradient: JAX and the port.
    _, jgrads = jdiff.render_and_grads(jdiff.DiffScene(*(jnp.asarray(a) for a in leaves)), **kw)
    scene = tdiff.diff_scene_from_numpy(*leaves, device="cpu")
    _, tgrads = tdiff.render_and_grads(scene, device="cpu", **kw)

    # The march's adjoint (the port's plain version): its own density
    # gradient and the upstream of the baked grid.
    with torch.no_grad():
        m = tdiff.march_setup(scene, kernels=False,
                              sun_cos_half_angle=math.cos(math.radians(0.53) / 2.0), **kw)
    dens_leaf = scene.density.clone().requires_grad_(True)
    baked_leaf = m.baked.clone().requires_grad_(True)
    rad = tdiff.quadrature_march_plain(dens_leaf, baked_leaf, None, m.entry, m.dirs, m.p_phase,
                                       m.meta, kw["remat_chunk"])
    img = torch.where(m.hit[:, None], scene.light_radiance[None, :] * rad[:, None], 0.0)
    d_march, gbar = torch.autograd.grad(img.mean(), (dens_leaf, baked_leaf))

    # The bake's adjoint on that upstream: JAX (float32 sums), the port
    # (float64 sums), the float64 witness.
    sun_n = scene.sun_dir / torch.linalg.norm(scene.sun_dir)
    dm, step = kw["density_multiplier"], kw["sample_step"]
    bbox = tdiff._bbox(scene.density)
    jbake = lambda d, l: jdiff.bake_inscatter_diff(jgrid.pack_corners(d), jnp.asarray(  # noqa: E731
        bbox.numpy()), l, dm, step)
    _, vjp = jax.vjp(jbake, jnp.asarray(density), jnp.asarray(sun_n.numpy()))
    j_bake = np.asarray(vjp(jnp.asarray(gbar.numpy()))[0])
    dl = scene.density.clone().requires_grad_(True)
    (t_bake,) = torch.autograd.grad(
        tdiff.bake_inscatter_diff_plain(dl, bbox, sun_n, dm, step), dl, gbar)
    d64 = scene.density.to(torch.float64).requires_grad_(True)
    n_bake = inscatter.bake_steps(step, False)
    (w_bake,) = torch.autograd.grad(
        bake64(d64, sun_n.to(torch.float64), dm, step, n_bake).reshape(density.shape), d64,
        gbar.to(torch.float64))
    w_full = w_bake + d_march.to(torch.float64)

    face = np.zeros(density.shape, bool)
    for axis in range(3):
        idx = [slice(None)] * 3
        for end in (0, density.shape[axis] - 1):
            idx[axis] = end
            face[tuple(idx)] = True
    w = w_bake.numpy()
    j_err = np.abs(j_bake - w)
    out = dict(
        point=f"procedural:{CLOUD[0]}:{CLOUD[1]} render_single_scatter defaults, baked",
        render_port_vs_jax=rel(tgrads.density.numpy(), np.asarray(jgrads.density)),
        render_port_vs_witness=rel(tgrads.density.numpy(), w_full.numpy()),
        render_jax_vs_witness=rel(np.asarray(jgrads.density), w_full.numpy()),
        bake_port_vs_witness=rel(t_bake.numpy(), w),
        bake_jax_vs_witness=rel(j_bake, w),
        bake_jax_vs_witness_faces=float(j_err[face].max() / np.abs(w).max()),
        bake_jax_vs_witness_inside=float(j_err[~face].max() / np.abs(w).max()),
        seconds=round(time.time() - t_start, 1),
    )
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
