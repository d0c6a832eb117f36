"""Pinhole camera, box intersection and miss shading.

The port of ``deepestscatter_tpu.render.camera``: ray generation through
eye/U/V/W (sutil::calculateCameraVariables), the slab test against the
centered cloud box, the sun disc and the sun-disc / sky-gradient miss
radiance.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import CameraConfig, fov_tan_halves
from ..ops.grid import true_div
from ..scene import SceneParams, SceneStatic


class CameraBasis(NamedTuple):
    eye: np.ndarray  # [3] float32
    u: np.ndarray  # [3] right axis, scaled by tan(hfov/2) * |W|
    v: np.ndarray  # [3] up axis, scaled by tan(vfov/2) * |W|
    w: np.ndarray  # [3] view axis, |W| = focal distance


def camera_basis(cfg: CameraConfig, rotation: Optional[np.ndarray] = None) -> CameraBasis:
    """Eye/U/V/W from config (host float32).  ``rotation`` (optional [3, 3])
    orbits the eye and the up vector about the look-at point, the arcball
    camera's frame (Camera.cpp:100-134)."""
    eye = np.asarray(cfg.eye, np.float32)
    look_at = np.asarray(cfg.look_at, np.float32)
    up = np.asarray(cfg.up, np.float32)
    if rotation is not None:
        rot = np.asarray(rotation, np.float32)
        eye = look_at + (eye - look_at) @ rot.T
        up = up @ rot.T
    w = look_at - eye
    wlen = np.linalg.norm(w)
    u = np.cross(w, up)
    u /= np.linalg.norm(u)
    v = np.cross(u, w)
    v /= np.linalg.norm(v)
    tan_h, tan_v = fov_tan_halves(cfg.hfov_deg, cfg.width, cfg.height)
    u = u * wlen * tan_h
    v = v * wlen * tan_v
    return CameraBasis(
        eye=eye,
        u=np.asarray(u, np.float32),
        v=np.asarray(v, np.float32),
        w=np.asarray(w, np.float32),
    )


def norm3(d: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of size 3, summed in index order."""
    sq = d * d
    return torch.sqrt(sq[..., 0] + sq[..., 1] + sq[..., 2])


def generate_rays(
    basis: CameraBasis, width: int, height: int, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """All primary rays of a frame → (origins [H*W, 3], directions [H*W, 3]).
    Pixel (x, y) maps to NDC ``(x, y) / (W, H) * 2 - 1``."""
    f32 = torch.float32
    xs = (torch.arange(width, dtype=f32, device=device) / width) * 2.0 - 1.0
    ys = (torch.arange(height, dtype=f32, device=device) / height) * 2.0 - 1.0
    dy, dx = torch.meshgrid(ys, xs, indexing="ij")  # [H, W]

    def vec(a):
        return torch.as_tensor(a, dtype=f32, device=device)

    d = dx[..., None] * vec(basis.u) + dy[..., None] * vec(basis.v) + vec(basis.w)
    d = d / norm3(d)[..., None]
    origins = vec(basis.eye).expand(d.shape)
    return origins.reshape(-1, 3), d.reshape(-1, 3)


def intersect_box(
    origins: torch.Tensor,
    directions: torch.Tensor,
    static: SceneStatic,
    bbox_size: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab test against the centered box [-bbox/2, +bbox/2] → (hit [N],
    t_hit [N]); rays starting inside hit at ``minimal_ray_distance``."""
    half = bbox_size * 0.5
    inv = 1.0 / directions
    t0 = (-half - origins) * inv
    t1 = (half - origins) * inv
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    hit = (t_near < t_far) & (t_far > 0.0)
    t_hit = torch.clamp(t_near, min=static.minimal_ray_distance)
    return hit, t_hit


def entry_points(
    origins: torch.Tensor, directions: torch.Tensor, t_hit: torch.Tensor,
    bbox_size: torch.Tensor,
) -> torch.Tensor:
    """Box entry points in local coordinates [0, bbox]."""
    return origins + directions * t_hit[:, None] + 0.5 * bbox_size


def sky_gradient(params: SceneParams, directions: torch.Tensor) -> torch.Tensor:
    """Ground-to-sky lerp on direction.y (cloud.cuh sampleSky:124-132)."""
    t = torch.clamp(true_div(directions[..., 1] + 0.5, 1.5), 0.0, 1.0)[..., None]
    return params.ground_intensity * (1.0 - t) + params.sky_intensity * t


def cos_to_sun(light_dir: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """``(-light_dir * d).sum(-1)``, summed in index order."""
    p = -light_dir * directions
    return p[..., 0] + p[..., 1] + p[..., 2]


def in_sun_disc(
    params: SceneParams, static: SceneStatic, directions: torch.Tensor
) -> torch.Tensor:
    """[...] bool: the direction looks into the sun disc."""
    return cos_to_sun(params.light_dir, directions) > static.sun_cos_half_angle


def sun_disc(
    params: SceneParams, static: SceneStatic, directions: torch.Tensor
) -> torch.Tensor:
    """Full sun radiance inside the disc, else 0 (cloud.cuh
    sampleSun:134-144)."""
    return torch.where(
        in_sun_disc(params, static, directions)[..., None],
        params.light_radiance.expand(directions.shape),
        torch.zeros_like(directions),
    )


def miss_radiance(
    params: SceneParams, static: SceneStatic, directions: torch.Tensor
) -> torch.Tensor:
    """Sun disc else sky gradient (pathTracingCamera.cu:31-51)."""
    return torch.where(
        in_sun_disc(params, static, directions)[..., None],
        sun_disc(params, static, directions),
        sky_gradient(params, directions),
    )
