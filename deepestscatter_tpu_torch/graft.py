"""Entry points for a compile check and a multi-device dry run.

The port of the repository's ``__graft_entry__.py``:

- ``entry()``: the flagship model's forward step and example arguments:
  one RPNN neural render of a ray batch (K1, K2 and the MLP);
- ``dryrun_multichip(n)``: ``n`` ranks (``parallel.launch``) run one step
  of each multi-device program on tiny shapes: a data-parallel training
  step (the batch sharded, the gradient averaged by one ``all_reduce``),
  one sharded progressive tick (rays sharded, the unconverged count
  reduced) and, for even ``n``, one subframe on a ``data`` x ``space``
  mesh (rays over ``n / 2`` data groups, the grid in 2 slabs).  Over gloo
  on the CPU for ``device="cpu"``, else on the card(s).
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def _tiny_scene(resolution: int = 16, width: int = 16, height: int = 8, device="cuda"):
    from . import config
    from .data import procedural
    from .render import camera as camera_ops
    from .scene import build_scene

    dev = resolve_device(device)
    # One subframe a tick: the plain path tracer's lockstep loop (the CPU
    # dry run) runs ten in ~20 s.
    cfg = config.SceneConfig(cloud=config.CloudModel(size_m=800.0),
                             camera=config.CameraConfig(width=width, height=height),
                             progressive=config.ProgressiveConfig(subframes_per_tick=1))
    params, static = build_scene(cfg, procedural.cumulus(resolution=resolution, seed=1),
                                 device=dev)
    basis = camera_ops.camera_basis(cfg.camera)
    origins, directions = camera_ops.generate_rays(basis, width, height, dev)
    return cfg, params, static, origins, directions


def entry(device="cuda"):
    """(fn, example_args): one RPNN neural render of a ray batch,
    ``fn(origins, directions) -> radiance [N, 3]``."""
    from .models.rpnn import init_disney_model
    from .render import neural

    _, params, static, origins, directions = _tiny_scene(device=device)
    model = init_disney_model(0, device=device)

    def forward(origins, directions):
        return neural.render_disney(params, static, model, origins, directions, 0,
                                    device=device)

    return forward, (origins, directions)


def dryrun_rank(device="cuda") -> dict:
    """One rank's share of ``dryrun_multichip`` (its process group up)."""
    import torch.distributed as dist

    from .models.blocks import flax_init
    from .models.rpnn import DisneyModel
    from .parallel import make_mesh
    from .parallel.jobs import where
    from .parallel.mesh import all_gather_cat
    from .parallel.render import ShardedProgressiveRenderer
    from .parallel.spatial_render import make_spatial_subframe, shard_scene
    from .render.inscatter import with_baked_inscatter
    from .train import trainer as trainer_mod

    dev = resolve_device(device)
    n = dist.get_world_size()
    mesh = make_mesh(device_type=dev.type)

    # Data-parallel training step: the batch over "data", the gradient
    # averaged.
    model = flax_init(DisneyModel(), 566, dev)
    opt = trainer_mod.AmsGrad(list(model.parameters()), 1e-3)
    b = 4 * n
    rng = np.random.default_rng(0)
    z = torch.as_tensor(rng.random((b, 10, 226), np.float32), device=dev)
    labels = torch.as_tensor(rng.random((b,), np.float32), device=dev)
    group = mesh.get_group("data")
    rows = trainer_mod.data_shard(b, group)
    loss = float(trainer_mod.train_step(model, opt, lambda m, x: m(x), z[rows], labels[rows],
                                        group))
    if not np.isfinite(loss):
        raise FloatingPointError(f"data-parallel training step: loss {loss}")

    # Sharded progressive tick: rays over "data".
    cfg, params, static, _, _ = _tiny_scene(width=8 * n, height=8, device=dev)
    params = with_baked_inscatter(params, static, device=dev)
    renderer = ShardedProgressiveRenderer(cfg, params, static, mesh, seed=1, device=dev)
    renderer.tick()
    img = renderer.hdr_image()
    if not np.all(np.isfinite(img)):
        raise FloatingPointError("sharded render produced a non-finite pixel")

    # data x space: rays over the data groups, the grid in 2 slabs.
    mean2d = float("nan")
    if n % 2 == 0:
        n_data = n // 2
        mesh2d = make_mesh((n_data, 2), ("data", "space"), device_type=dev.type)
        _, p2, s2, o2, d2 = _tiny_scene(width=8 * n_data, height=8, device=dev)
        p2 = with_baked_inscatter(p2, s2, device=dev)
        fn = make_spatial_subframe(mesh2d, s2, axis="space", data_axis="data")
        out = fn(shard_scene(mesh2d, p2, axis="space", device=dev), o2, d2, 1, 1)
        out = all_gather_cat(out, mesh2d.get_group("data")).cpu().numpy()
        if not np.all(np.isfinite(out)):
            raise FloatingPointError("data x space render produced a non-finite pixel")
        mean2d = float(out.mean())
    return dict(where(), loss=loss, render_mean=float(img.mean()), mean2d=mean2d)


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """``dryrun_rank`` on ``n_devices`` ranks → their results; prints one
    line."""
    from .parallel import launch

    out = launch.run("deepestscatter_tpu_torch.graft:dryrun_rank", n_devices, device=device)
    r = out[0]
    print(f"dryrun_multichip({n_devices}) over {r['backend']} on {r['device']}: train loss "
          f"{r['loss']:.4f}, render mean {r['render_mean']:.4f}, data x space mean "
          f"{r['mean2d']:.4f} — OK", flush=True)
    return out
