"""Process groups and device meshes: the communication substrate.

The port of ``deepestscatter_tpu.parallel.mesh``.  A JAX mesh names the
devices of one program; here each device is a process (a rank) of a
``torch.distributed`` process group, and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the group's ranks with
the JAX package's axis names:

- ``data``: rays for rendering, the batch for training;
- ``space``: z-slabs of the grid (``parallel.spatial_render``).

Collectives are NCCL's on the card and gloo's on the CPU.  Gloo also runs
``all_reduce`` and ``broadcast`` on CUDA tensors (ranks that share a card,
as on a one-card machine), but not ``send``/``recv`` or ``all_gather``:
for those ``host_staged`` copies the one buffer through the host, and
only under gloo; the arithmetic stays on the card.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import resolve_device

#: The environment a bare ``initialize_distributed()`` reads its
#: rendezvous from (what ``torchrun`` sets).
RENDEZVOUS_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def default_backend(device="cuda") -> str:
    """NCCL for the card, gloo for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def initialize_distributed(device="cuda", **kwargs) -> bool:
    """Bring up the default process group (``init_process_group``; the
    backend defaults to ``default_backend(device)``).

    Returns True when the group is (now or already) up.  A request with
    arguments (``init_method``, ``world_size``, ``rank``, ``backend``, ...)
    that fails raises; only the bare call with no rendezvous in the
    environment (``RENDEZVOUS_ENV``, as ``torchrun`` sets it) returns
    False, for single-process operation."""
    if dist.is_initialized():
        return True
    if not kwargs and not all(k in os.environ for k in RENDEZVOUS_ENV):
        return False
    kwargs.setdefault("backend", default_backend(device))
    dist.init_process_group(**kwargs)
    return True


def make_mesh(
    axis_sizes: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data",),
    device_type: str = "cuda",
) -> DeviceMesh:
    """A mesh over the ranks of the default process group (raises if it is
    not up).  Default: all ranks on the first axis.  ``axis_sizes``
    reshapes, e.g. ``(2, 2)`` with names ``("data", "space")``: rank
    ``r`` is at ``(r // 2, r % 2)``."""
    resolve_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed")
    world = dist.get_world_size()
    names = tuple(axis_names)
    if axis_sizes is None:
        axis_sizes = (world,) + (1,) * (len(names) - 1)
    return init_device_mesh(device_type, tuple(axis_sizes), mesh_dim_names=names)


def axis_group(mesh: DeviceMesh, axis: str):
    """(process group, size, this rank's index) of ``mesh``'s axis."""
    return mesh.get_group(axis), mesh.size(mesh.mesh_dim_names.index(axis)), \
        mesh.get_local_rank(axis)


def host_staged(t: torch.Tensor, group) -> torch.Tensor:
    """The buffer a ``send``/``recv``/``all_gather`` of ``t`` moves over
    ``group``: ``t`` itself, or its host copy where the group is gloo's and
    ``t`` lies on the card (gloo has no CUDA point-to-point or gather).
    The caller copies a result back to ``t``'s device."""
    if t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        return t.cpu()
    return t


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """The group's ``t`` (equal shapes) concatenated on dim 0 in rank
    order, on ``t``'s device."""
    buf = host_staged(t.contiguous(), group)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts).to(t.device)
