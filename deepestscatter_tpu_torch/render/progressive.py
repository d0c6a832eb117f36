"""Progressive estimation: Welford accumulation and the CI convergence gate.

The port of ``deepestscatter_tpu.render.progressive`` (reference:
Camera.cpp): each tick folds ``subframes_per_tick`` new samples per pixel
into a running Welford state; after ``min_subframes`` a pixel converges
when its 95 % CI on the red channel is below ``rel_tol`` (relative) or
``abs_tol`` (absolute), and the frame is done when fewer than
``max_unconverged_pixels`` remain (:232-268).

A tick is one K4 launch over every pixel (``pathtracer.trace_tick_moments``)
and one Welford merge.  The JAX package's lane banding is left out: it
bounds the length of one XLA call on a TPU, and a CUDA launch has no such
limit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import ProgressiveConfig, SceneConfig
from ..device import check_on, resolve_device
from ..ops import tonemap as tonemap_ops
from ..ops import welford as welford_ops
from ..scene import SceneParams, SceneStatic
from . import camera as camera_ops
from . import pathtracer

#: Sentinel painted over non-finite radiance: the reference's exception
#: program colour (Camera.cpp:35, progressive.cu:36-39).
ERROR_COLOR = 123123123.123


def paint_error_pixels(sample: torch.Tensor) -> torch.Tensor:
    """Replace NaN / Inf radiance with ``ERROR_COLOR``."""
    return torch.where(
        torch.isfinite(sample), sample, torch.full_like(sample, ERROR_COLOR)
    )


class ProgressiveState(NamedTuple):
    mean: torch.Tensor  # [N, 3] running radiance mean
    m2: torch.Tensor  # [N, 3] running sum of squared deviations
    count: torch.Tensor  # [N, 1] samples folded per pixel (the CI's N)
    subframe_id: int  # scheduled subframes (seeds and cadence)


def init_state(n_rays: int, device="cuda") -> ProgressiveState:
    dev = resolve_device(device)
    z = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    return ProgressiveState(
        mean=z, m2=z.clone(),
        count=torch.zeros((n_rays, 1), dtype=torch.float32, device=dev),
        subframe_id=0,
    )


def unconverged_count(state: ProgressiveState, cfg: ProgressiveConfig) -> torch.Tensor:
    """Pixels failing the 95 % CI gate on the red channel (Camera.cpp:244-255
    uses ``.x``), with each pixel's folded sample count as its N."""
    red = welford_ops.Welford(state.mean[:, 0], state.m2[:, 0], state.count[:, 0])
    return (~welford_ops.is_converged(red, cfg.rel_tol, cfg.abs_tol)).sum()


def tick_sample_moments(
    params: SceneParams,
    static: SceneStatic,
    origins: torch.Tensor,
    directions: torch.Tensor,
    seed_base: int,
    sub0: int,
    n_subframes: int,
    ray_ids: Optional[torch.Tensor] = None,
    device="cuda",
):
    """Welford moments ``(mean [N, 3], m2 [N, 3], count [N, 1])`` of one
    tick's fresh samples.  A pixel with a non-finite moment gets
    ``ERROR_COLOR`` as its mean and zero m2, so the sentinel dominates the
    image and garbage never enters the CI gate as a variance."""
    mean, m2, cnt = pathtracer.trace_tick_moments(
        params, static, origins, directions, seed_base, sub0, n_subframes,
        ray_ids=ray_ids, device=device,
    )
    bad = ~torch.all(torch.isfinite(mean) & torch.isfinite(m2), dim=-1)
    mean = torch.where(bad[:, None], torch.full_like(mean, ERROR_COLOR), mean)
    m2 = torch.where(bad[:, None], torch.zeros_like(m2), m2)
    return mean, m2, cnt[:, None]


def render_tick(
    params: SceneParams,
    static: SceneStatic,
    origins: torch.Tensor,
    directions: torch.Tensor,
    state: ProgressiveState,
    seed_base: int = 0,
    n_subframes: int = 10,
    device="cuda",
) -> ProgressiveState:
    """Fold ``n_subframes`` new samples per pixel into ``state`` with the
    exact pairwise Welford merge (the reference renders 10 subframes per
    display tick, Camera.cpp:189-200)."""
    batch = welford_ops.Welford(
        *tick_sample_moments(
            params, static, origins, directions, seed_base,
            state.subframe_id, n_subframes, device=device,
        )
    )
    merged = welford_ops.merge(
        welford_ops.Welford(state.mean, state.m2, state.count), batch
    )
    return ProgressiveState(
        merged.mean, merged.m2, merged.count, state.subframe_id + n_subframes
    )


class ProgressiveRenderer:
    """Host-side progressive loop (the reference's GuiExecutionLoop and
    Camera, without the GUI): ticks until the CI gate passes, optionally
    handing HDR snapshots to ``snapshot_fn``."""

    def __init__(
        self,
        cfg: SceneConfig,
        params: SceneParams,
        static: SceneStatic,
        seed: int = 0,
        snapshot_fn: Optional[Callable[[int, np.ndarray], None]] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        check_on(self.device, params.density_mips[0])
        self.cfg = cfg
        self.params = params
        self.static = static
        self.seed = seed
        self.snapshot_fn = snapshot_fn
        basis = camera_ops.camera_basis(cfg.camera)
        self.origins, self.directions = camera_ops.generate_rays(
            basis, cfg.camera.width, cfg.camera.height, self.device
        )
        self.state = init_state(self.origins.shape[0], self.device)

    @property
    def n_rays(self) -> int:
        return self.origins.shape[0]

    def tick(self) -> int:
        """Render one tick; returns the current unconverged-pixel count
        (every pixel before ``min_subframes``)."""
        p = self.cfg.progressive
        self.state = render_tick(
            self.params, self.static, self.origins, self.directions, self.state,
            seed_base=self.seed, n_subframes=p.subframes_per_tick,
            device=self.device,
        )
        sf = self.state.subframe_id
        if self.snapshot_fn is not None and sf % p.snapshot_every == 0:
            self.snapshot_fn(sf, self.hdr_image())
        if sf < p.min_subframes:
            return self.n_rays
        return int(unconverged_count(self.state, p))

    def run(self, verbose: bool = False) -> np.ndarray:
        """Render to convergence (or ``max_subframes``); returns the HDR
        image [H, W, 3]."""
        p = self.cfg.progressive
        while self.state.subframe_id < p.max_subframes:
            remaining = self.tick()
            if verbose:
                print(f"subframe {self.state.subframe_id}: {remaining} unconverged")
            if (
                self.state.subframe_id >= p.min_subframes
                and remaining < p.max_unconverged_pixels
            ):
                break
        return self.hdr_image()

    def hdr_image(self) -> np.ndarray:
        h, w = self.cfg.camera.height, self.cfg.camera.width
        return self.state.mean.reshape(h, w, 3).cpu().numpy()

    def display_image(self) -> np.ndarray:
        """Tone-mapped uint8 image (Reinhard and gamma, reinhard.cu)."""
        hdr = self.state.mean.reshape(self.cfg.camera.height, self.cfg.camera.width, 3)
        out = tonemap_ops.reinhard(hdr, self.cfg.camera.exposure)
        return tonemap_ops.to_uint8(out).cpu().numpy()
