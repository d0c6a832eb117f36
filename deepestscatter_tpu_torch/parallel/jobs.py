"""What a rank runs in the multi-device checks: one function a path, each
called on every rank by ``parallel.launch.run`` (the ranks' process
group up) and returning host values.  The tests, ``chip_smoke.py`` and
``graft.dryrun_multichip`` compare what the ranks return with the
one-device paths.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..render import camera as camera_ops
from ..render.inscatter import bake, with_baked_inscatter
from ..scene import build_scene
from . import mesh as mesh_mod
from .render import ShardedProgressiveRenderer
from .spatial import HaloSlabGrid, replicate_coarse_mips, sharded_inscatter_bake
from .spatial_render import make_spatial_subframe, shard_scene


def where() -> dict:
    """This rank's backend and device (what ``chip_smoke.py`` prints)."""
    dev = f"cuda:{torch.cuda.current_device()}" if torch.cuda.is_available() else "cpu"
    return dict(rank=dist.get_rank(), backend=str(dist.get_backend()), device=dev)


def scene(cfg, density: np.ndarray, device, baked: bool = True, inscatter=None):
    """The scene on ``device``, its in-scatter grid ``inscatter`` (a host
    array) where given, else baked where ``baked``."""
    params, static = build_scene(cfg, density, inscatter, device=device)
    if baked and inscatter is None:
        params = with_baked_inscatter(params, static, device=device)
    return params, static


def tick(cfg, density: np.ndarray, seed: int, device="cuda", ticks: int = 1,
         inscatter=None) -> dict:
    """``ticks`` ticks of ``ShardedProgressiveRenderer`` over all ranks on
    the ``data`` axis → the whole frame's state (gathered), the counts the
    ticks returned and the image."""
    dev = resolve_device(device)
    mesh = mesh_mod.make_mesh(device_type=dev.type)
    params, static = scene(cfg, density, dev, inscatter=inscatter)
    r = ShardedProgressiveRenderer(cfg, params, static, mesh, seed=seed, device=dev)
    counts = [r.tick() for _ in range(ticks)]
    g = r.group
    return dict(where(), counts=counts, image=r.hdr_image(),
                mean=mesh_mod.all_gather_cat(r.state.mean, g).cpu(),
                m2=mesh_mod.all_gather_cat(r.state.m2, g).cpu(),
                count=mesh_mod.all_gather_cat(r.state.count, g).cpu(),
                shard=tuple(r.origins.shape))


def sharded_bake(cfg, density: np.ndarray, device="cuda") -> dict:
    """The sharded bake over all ranks and the one-rank ``bake``."""
    dev = resolve_device(device)
    mesh = mesh_mod.make_mesh(device_type=dev.type)
    params, static = scene(cfg, density, dev, baked=False)
    return dict(where(), sharded=sharded_inscatter_bake(mesh, params, static, device=dev).cpu(),
                whole=bake(params, static, device=dev).cpu())


def halos(grid: np.ndarray, device="cuda") -> dict:
    """``HaloSlabGrid.scatter`` and ``exchange_halos`` of ``grid`` over all
    ranks; ``replicate_coarse_mips`` of a two-level pyramid whose values
    are the rank's."""
    dev = resolve_device(device)
    mesh = mesh_mod.make_mesh(device_type=dev.type)
    slabs = HaloSlabGrid(mesh, halo=1)
    scattered = slabs.scatter(grid, dev)
    owned = scattered[1:-1].contiguous()
    rank = float(dist.get_rank())
    mips = (torch.full((2, 2, 2), rank, device=dev), torch.full((1, 1, 1), rank + 10.0, device=dev))
    mips = replicate_coarse_mips(mesh, mips)
    return dict(where(), scatter=scattered.cpu(), exchange=slabs.exchange_halos(owned).cpu(),
                mips=[m.cpu() for m in mips])


def spatial(cfg, density: np.ndarray, seed: int, subframe: int, mesh_shape: Sequence[int],
            device="cuda", steps_per_phase: Optional[int] = None, rays=None,
            inscatter=None) -> dict:
    """One sharded-grid subframe on a ``(data, space)`` mesh of
    ``mesh_shape`` (``(1, n)``: space only) → this rank's radiance shard
    and slab, the phases and steps.  ``rays``: (origins, directions,
    ray ids) as host tensors (default the camera's)."""
    dev = resolve_device(device)
    mesh = mesh_mod.make_mesh(tuple(mesh_shape), ("data", "space"), device_type=dev.type)
    params, static = scene(cfg, density, dev, inscatter=inscatter)
    sc = shard_scene(mesh, params, axis="space", device=dev)
    fn = make_spatial_subframe(mesh, static, axis="space", steps_per_phase=steps_per_phase,
                               data_axis="data" if mesh_shape[0] > 1 else None)
    if rays is None:
        basis = camera_ops.camera_basis(cfg.camera)
        o, d = camera_ops.generate_rays(basis, cfg.camera.width, cfg.camera.height, dev)
        ids = torch.arange(o.shape[0], dtype=torch.int64, device=dev)
    else:
        o, d, ids = (t.to(dev) for t in rays)
    out = fn(sc, o, d, seed, subframe, ids)
    return dict(where(), radiance=out.cpu(), slab=tuple(sc.density.shape), z0=sc.z0,
                phases=fn.last_phases, steps=fn.last_steps)


def train_tables(n_rows: int, seed: int, device):
    """Seeded RPNN training tables on ``device``: uint8 descriptor rows
    [n_rows, 2250], omega and labels [n_rows]."""
    rng = np.random.default_rng(seed)
    put = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return (put(rng.integers(0, 256, (n_rows, 2250), dtype=np.uint8)),
            put(rng.random(n_rows).astype(np.float32) * np.float32(np.pi)),
            put(rng.random(n_rows).astype(np.float32) * np.float32(3.0)))


def train_chunk(n_rows: int, batch: int, steps: int, seed: int = 0, lr: float = 1e-3,
                distributed: bool = True, device="cuda") -> dict:
    """One chunk of ``steps`` optimizer steps (``trainer.chunk_step``) of
    a ``flax_init`` RPNN on batches of ``batch`` rows that K10 assembles
    from seeded tables, data-parallel over all ranks (``distributed``) or
    on this rank alone → the losses, the flat parameters, K10's
    launches."""
    from ..models.blocks import flax_init
    from ..models.rpnn import DisneyModel
    from ..train import device_data as dd
    from ..train import trainer as trainer_mod

    dev = resolve_device(device)
    group = mesh_mod.make_mesh(device_type=dev.type).get_group("data") if distributed else None
    grids, omega, labels = train_tables(n_rows, seed, dev)
    sched = np.stack([np.random.default_rng(seed + 1 + k).permutation(n_rows)[:batch]
                      for k in range(steps)])
    model = flax_init(DisneyModel(), 566, dev)
    opt = trainer_mod.AmsGrad(list(model.parameters()), lr)
    before = dd.assemble_disney.launches
    losses = trainer_mod.chunk_step(
        model, opt, lambda m, b: m(b), lambda idx: dd.assemble_disney(grids, omega, labels, idx),
        torch.as_tensor(sched, dtype=torch.int64, device=dev), group)
    return dict(where(), losses=losses.cpu(), params=trainer_mod.flat_params(model).cpu(),
                k10_launches=dd.assemble_disney.launches - before)


def several(calls: Sequence, device="cuda") -> list:
    """Several of this module's jobs in turn on the same ranks: ``calls``
    is ``[(name, kwargs), ...]`` → their results."""
    return [globals()[name](device=device, **kw) for name, kw in calls]


def train_steps(model, state: dict, batches: Sequence, lr: float, device="cuda") -> dict:
    """Data-parallel optimizer steps over all ranks: ``model`` (an
    ``nn.Module``) loaded with ``state``, each ``(z [B, L, 226], labels
    [B])`` batch's shard → the losses and the flat parameters."""
    from ..train import trainer as trainer_mod

    dev = resolve_device(device)
    mesh = mesh_mod.make_mesh(device_type=dev.type)
    group = mesh.get_group("data")
    model.load_state_dict(state)
    model = model.to(dev)
    opt = trainer_mod.AmsGrad(list(model.parameters()), lr)
    losses = []
    for z, labels in batches:
        rows = trainer_mod.data_shard(len(labels), group)
        z = torch.as_tensor(np.asarray(z)[rows], device=dev)
        y = torch.as_tensor(np.asarray(labels)[rows], device=dev)
        losses.append(float(trainer_mod.train_step(model, opt, lambda m, b: m(b), z, y, group)))
    return dict(where(), losses=losses, params=trainer_mod.flat_params(model).cpu())
