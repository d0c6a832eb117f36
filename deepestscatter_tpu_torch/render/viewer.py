"""Interactive progressive-render session (GuiExecutionLoop parity).

The port of ``deepestscatter_tpu.render.viewer``.  The reference opens a
glut window whose idle callback drives ``Scene::update`` and whose
keyboard and mouse handlers adjust exposure (``+``/``-``), pause (space)
and orbit the camera with a quaternion arcball (GuiExecutionLoop.cpp:
114-185, Util/Arcball).  Headless here, the same capability is an object
API any frontend can drive:

- ``tick()``: one progressive tick, then the tone-mapped uint8 frame;
- ``drag(x0, y0, x1, y1)``: an arcball orbit in normalized window
  coordinates, which resets the progressive estimate (the camera moved);
- ``adjust_exposure`` / ``toggle_pause``: the keyboard handlers;
- ``snapshot(path)``: a PNG or EXR of the current image.

``InteractiveSession`` runs on ``device="cuda"`` unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..config import SceneConfig
from ..device import resolve_device
from ..ops import tonemap as tonemap_ops
from ..scene import SceneParams, SceneStatic
from ..utils import exr as exr_mod
from ..utils import png as png_mod
from . import camera as camera_ops
from .progressive import ProgressiveRenderer


def arcball_rotation(x0: float, y0: float, x1: float, y1: float,
                     radius: float = 1.0) -> np.ndarray:
    """Rotation matrix (float32) for a drag between two normalized window
    points ([-1, 1]^2), the quaternion arcball of Util/Arcball: each point
    mapped onto the unit sphere (or its hyperbolic skirt), one rotated onto
    the other.  float64 numpy, as the JAX package computes it."""

    def to_sphere(x, y):
        p = np.asarray([x / radius, y / radius, 0.0], np.float64)
        r2 = p[0] ** 2 + p[1] ** 2
        if r2 <= 1.0:
            p[2] = np.sqrt(1.0 - r2)
        else:
            p /= np.sqrt(r2)
        return p

    a = to_sphere(x0, y0)
    b = to_sphere(x1, y1)
    axis = np.cross(a, b)
    s = np.linalg.norm(axis)
    c = float(np.clip(np.dot(a, b), -1.0, 1.0))
    if s < 1e-12:
        return np.eye(3, dtype=np.float32)
    axis = axis / s
    angle = np.arctan2(s, c)
    k = np.asarray(
        [
            [0, -axis[2], axis[1]],
            [axis[2], 0, -axis[0]],
            [-axis[1], axis[0], 0],
        ]
    )
    rot = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)
    return rot.astype(np.float32)


class InteractiveSession:
    """Headless interactive render loop over a scene."""

    def __init__(self, cfg: SceneConfig, params: SceneParams, static: SceneStatic,
                 seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.static = static
        self.seed = seed
        self.exposure = cfg.camera.exposure
        self.paused = False
        self.rotation = np.eye(3, dtype=np.float32)
        #: Smoothed per-tick wall time (the reference's MS/FRAME readout).
        self.ms_per_frame: Optional[float] = None
        self._rebuild()

    def _rebuild(self) -> None:
        self.renderer = ProgressiveRenderer(self.cfg, self.params, self.static, seed=self.seed,
                                            device=self.device)
        basis = camera_ops.camera_basis(self.cfg.camera, rotation=self.rotation)
        self.renderer.origins, self.renderer.directions = camera_ops.generate_rays(
            basis, self.cfg.camera.width, self.cfg.camera.height, self.device)

    # -- handlers (GuiExecutionLoop.cpp:143-185) ---------------------------

    def adjust_exposure(self, factor: float = 1.2) -> float:
        """The +/- keys scale the exposure (display-side: no re-render)."""
        self.exposure *= factor
        return self.exposure

    def toggle_pause(self) -> bool:
        self.paused = not self.paused
        return self.paused

    def drag(self, x0: float, y0: float, x1: float, y1: float) -> None:
        """Arcball orbit; resets the progressive estimate."""
        self.rotation = arcball_rotation(x0, y0, x1, y1) @ self.rotation
        self._rebuild()

    # -- the loop body ------------------------------------------------------

    def tick(self) -> np.ndarray:
        """One display tick → the tone-mapped uint8 [H, W, 3] frame, with a
        smoothed ``ms_per_frame`` (GuiExecutionLoop.cpp:114-128)."""
        t0 = time.perf_counter()
        if not self.paused:
            self.renderer.tick()
        frame = self.display_image()
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.ms_per_frame = (dt_ms if self.ms_per_frame is None
                             else 0.8 * self.ms_per_frame + 0.2 * dt_ms)
        return frame

    def display_image(self) -> np.ndarray:
        """The current estimate tone-mapped (Reinhard and gamma at the
        session's exposure) → uint8 [H, W, 3]."""
        cam = self.cfg.camera
        hdr = self.renderer.state.mean.reshape(cam.height, cam.width, 3)
        with torch.inference_mode():
            return tonemap_ops.to_uint8(tonemap_ops.reinhard(hdr, self.exposure)).cpu().numpy()

    @property
    def subframes(self) -> int:
        return int(self.renderer.state.subframe_id)

    def snapshot(self, path: str) -> None:
        """The tone-mapped frame as PNG (``.png``), else the HDR image as EXR."""
        if path.endswith(".png"):
            png_mod.write_png(path, self.display_image())
        else:
            exr_mod.write_exr(path, self.renderer.hdr_image())
