"""Data-parallel progressive path tracing over the ranks of a mesh axis.

The port of ``deepestscatter_tpu.parallel.render``: each rank holds a
contiguous shard of the frame's rays with their global ray ids (int64),
and the scene whole.  A tick runs K4 on the rank's shard
(``render.progressive.tick_sample_moments``) and the Welford merge there;
the one collective a tick is an ``all_reduce`` of the unconverged count.
``hdr_image`` gathers the shards.

K4 keys its random draws on (seed, global ray id, counter) and folds a
pixel's samples in sample order, whatever the shard: a tick's state is
bitwise the unsharded renderer's, at one subframe a tick and at several.
(The JAX package's compaction folds a pixel's subframes in shard-local
order, so it claims float agreement at several subframes.)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import ProgressiveConfig, SceneConfig
from ..device import check_on, resolve_device
from ..ops import welford as welford_ops
from ..render import camera as camera_ops
from ..render.progressive import (ProgressiveState, init_state, tick_sample_moments,
                                  unconverged_count)
from ..scene import SceneParams, SceneStatic
from .mesh import all_gather_cat, axis_group


def shard_range(n: int, parts: int, index: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of shard ``index`` of ``n`` split evenly over
    ``parts`` (raises unless they divide)."""
    if n % parts:
        raise ValueError(f"{n} rays must divide evenly over {parts} ranks")
    size = n // parts
    return index * size, (index + 1) * size


def sharded_tick(params: SceneParams, static: SceneStatic, origins, directions, ray_ids,
                 state: ProgressiveState, seed_base: int, n_subframes: int,
                 cfg: ProgressiveConfig, group, device="cuda"):
    """One tick of this rank's shard → (new state, the group's unconverged
    count as an int): ``n_subframes`` new samples a pixel (K4, global ray
    ids), the Welford merge, the 95 % CI gate on the red channel, and one
    ``all_reduce`` of the count."""
    batch = welford_ops.Welford(*tick_sample_moments(
        params, static, origins, directions, seed_base, state.subframe_id, n_subframes,
        ray_ids=ray_ids, device=device))
    merged = welford_ops.merge(welford_ops.Welford(state.mean, state.m2, state.count), batch)
    new = ProgressiveState(merged.mean, merged.m2, merged.count,
                           state.subframe_id + n_subframes)
    count = unconverged_count(new, cfg).reshape(1).to(torch.int64)
    dist.all_reduce(count, group=group)
    return new, int(count.item())


class ShardedProgressiveRenderer:
    """Progressive path tracing to convergence with the rays sharded over
    ``mesh``'s ``data_axis`` (ranks of other axes repeat their data shard):
    the multi-device ``render.progressive.ProgressiveRenderer``."""

    def __init__(self, cfg: SceneConfig, params: SceneParams, static: SceneStatic, mesh,
                 seed: int = 0, data_axis: str = "data", device="cuda"):
        self.device = resolve_device(device)
        check_on(self.device, params.density_mips[0])
        self.cfg, self.params, self.static, self.mesh, self.seed = cfg, params, static, mesh, seed
        self.group, self.n_ranks, self.rank = axis_group(mesh, data_axis)
        basis = camera_ops.camera_basis(cfg.camera)
        origins, directions = camera_ops.generate_rays(
            basis, cfg.camera.width, cfg.camera.height, self.device)
        self.n_total = origins.shape[0]
        lo, hi = shard_range(self.n_total, self.n_ranks, self.rank)
        self.origins = origins[lo:hi].contiguous()
        self.directions = directions[lo:hi].contiguous()
        self.ray_ids = torch.arange(lo, hi, dtype=torch.int64, device=self.device)
        self.state = init_state(hi - lo, self.device)

    def tick(self) -> int:
        """One tick; the frame's unconverged pixel count (every pixel
        before ``min_subframes``)."""
        p = self.cfg.progressive
        self.state, unconverged = sharded_tick(
            self.params, self.static, self.origins, self.directions, self.ray_ids,
            self.state, self.seed, p.subframes_per_tick, p, self.group, self.device)
        if self.state.subframe_id < p.min_subframes:
            return self.n_total
        return unconverged

    def run(self, verbose: bool = False) -> np.ndarray:
        p = self.cfg.progressive
        while self.state.subframe_id < p.max_subframes:
            remaining = self.tick()
            if verbose:
                print(f"subframe {self.state.subframe_id}: {remaining} unconverged")
            if self.state.subframe_id >= p.min_subframes and remaining < p.max_unconverged_pixels:
                break
        return self.hdr_image()

    def hdr_image(self) -> np.ndarray:
        """The whole frame's running mean [H, W, 3], gathered from the
        shards (on every rank)."""
        h, w = self.cfg.camera.height, self.cfg.camera.width
        return all_gather_cat(self.state.mean, self.group).reshape(h, w, 3).cpu().numpy()
