"""Spatial parallelism: the sharded in-scatter bake and halo slabs.

The port of ``deepestscatter_tpu.parallel.spatial``:

- ``sharded_inscatter_bake``: each rank of the axis bakes its range of z
  planes over the replicated density (K3 with a z range,
  ``inscatter.launch_bake(planes=)``; its plain version on the CPU), then
  the grid is gathered.  The same values as ``render.inscatter.bake``.
- ``HaloSlabGrid``: a ``[Z, ...]`` grid split into z-slabs of ``Z / n``
  planes with ``halo`` planes on each side (clamped to the grid's ends).
  ``scatter`` cuts a rank's slab from a host array, so the whole grid
  never goes onto a device; ``exchange_halos`` builds the halos from the
  neighbours' owned planes (``send``/``recv``).
- ``replicate_coarse_mips``: the coarse mip levels broadcast from the
  axis's first rank; level 0 stays as each rank has it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import check_on, resolve_device
from ..render import inscatter
from ..scene import SceneParams, SceneStatic
from .mesh import axis_group, host_staged


def plane_split(nz: int, parts: int, index: int):
    """Planes ``[z0, z1)`` of part ``index`` of ``nz`` planes split over
    ``parts`` as evenly as they go (the first ``nz % parts`` parts one
    plane longer)."""
    size, extra = divmod(nz, parts)
    z0 = index * size + min(index, extra)
    return z0, z0 + size + (1 if index < extra else 0)


def sharded_inscatter_bake(mesh, params: SceneParams, static: SceneStatic,
                           quantize: bool = True, data_axis: str = "data",
                           device="cuda") -> torch.Tensor:
    """The sun-transmittance grid [Z, Y, X], each rank of ``data_axis``
    baking its planes (``plane_split``), gathered on every rank."""
    dev = resolve_device(device)
    check_on(dev, params.density_mips[0])
    group, n, rank = axis_group(mesh, data_axis)
    nz, ny, nx = static.grid_shape
    z0, z1 = plane_split(nz, n, rank)
    part = inscatter.bake(params, static, quantize=quantize, device=dev, planes=(z0, z1))
    # all_gather takes equal shapes: pad each part to the longest.
    longest = plane_split(nz, n, 0)[1]
    padded = torch.zeros((longest, ny, nx), dtype=part.dtype, device=dev)
    padded[: z1 - z0] = part
    buf = host_staged(padded, group)
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    return torch.cat([p[: b - a] for p, (a, b) in
                      zip(parts, (plane_split(nz, n, r) for r in range(n)))]).to(dev)


def slab_planes(nz: int, index: int, n_slabs: int, halo: int = 1) -> np.ndarray:
    """The planes of a ``nz``-plane grid that slab ``index`` of
    ``n_slabs`` holds with its halos, in order (clamped to the grid)."""
    if nz % n_slabs:
        raise ValueError(f"Z={nz} must divide over {n_slabs} slabs")
    slab = nz // n_slabs
    return np.clip(np.arange(index * slab - halo, (index + 1) * slab + halo), 0, nz - 1)


def halo_slab(grid, index: int, n_slabs: int, halo: int = 1, device="cuda") -> torch.Tensor:
    """Slab ``index`` of ``n_slabs`` of ``grid`` (a host array or tensor)
    with its halos, cut on the host and put on ``device``."""
    host = grid.cpu().numpy() if isinstance(grid, torch.Tensor) else np.asarray(grid)
    piece = np.ascontiguousarray(host[slab_planes(host.shape[0], index, n_slabs, halo)])
    return torch.from_numpy(piece).to(resolve_device(device))


class HaloSlabGrid:
    """A ``[Z, ...]`` grid in z-slabs over ``mesh``'s ``axis``: rank ``d``
    holds ``[slab + 2 halo, ...]``, the planes ``d * slab - halo .. (d + 1)
    * slab + halo - 1`` clamped into the grid (clamp-to-edge at its ends,
    as the samplers clamp): any stencil within ``halo`` planes of the owned
    ones resolves locally."""

    def __init__(self, mesh, axis: str = "data", halo: int = 1):
        self.mesh, self.axis, self.halo = mesh, axis, halo
        self.group, self.n_ranks, self.rank = axis_group(mesh, axis)

    def scatter(self, grid, device="cuda") -> torch.Tensor:
        """This rank's halo slab of ``grid`` (a host array or tensor), cut
        on the host and put on ``device``: the whole grid never lies on a
        device."""
        return halo_slab(grid, self.rank, self.n_ranks, self.halo, device)

    def exchange_halos(self, owned: torch.Tensor) -> torch.Tensor:
        """Owned planes ``[slab, ...]`` → ``[slab + 2 halo, ...]`` with the
        halos received from the ring neighbours over the axis (one
        ``send``/``recv`` pair each way, ``host_staged`` under gloo on the
        card); the first and last ranks clamp to their own edge planes."""
        h, n, d = self.halo, self.n_ranks, self.rank
        below, above = owned[:h].clone(), owned[-h:].clone()
        if n > 1:
            peer = lambda i: dist.get_global_rank(self.group, i)  # noqa: E731
            send_up, send_down = host_staged(owned[-h:].contiguous(), self.group), \
                host_staged(owned[:h].contiguous(), self.group)
            recv_below, recv_above = torch.empty_like(send_up), torch.empty_like(send_down)
            reqs = []
            if d + 1 < n:
                reqs += [dist.isend(send_up, peer(d + 1), group=self.group),
                         dist.irecv(recv_above, peer(d + 1), group=self.group)]
            if d > 0:
                reqs += [dist.isend(send_down, peer(d - 1), group=self.group),
                         dist.irecv(recv_below, peer(d - 1), group=self.group)]
            for r in reqs:
                r.wait()
            if d > 0:
                below = recv_below.to(owned.device)
            if d + 1 < n:
                above = recv_above.to(owned.device)
        return torch.cat([below, owned, above])


def replicate_coarse_mips(mesh, mips: Sequence[torch.Tensor], shard_below_level: int = 1,
                          axis: str = "data"):
    """The shard / replicate split of the mip pyramid: levels from
    ``shard_below_level`` on are broadcast from the axis's first rank (in
    place), the finer ones left as they are → the levels."""
    group = axis_group(mesh, axis)[0]
    src = dist.get_global_rank(group, 0)
    for lvl, m in enumerate(mips):
        if lvl >= shard_below_level:
            dist.broadcast(m, src, group=group)
    return tuple(mips)
