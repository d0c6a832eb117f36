"""Scene state: device tensors plus static (host) scene facts.

The port of ``deepestscatter_tpu.scene``, cut to what the RPNN neural frame
and the path tracer read.  ``SceneParams`` holds the tensors (mip pyramid, in-scatter grid,
light and sky vectors, phase tables); ``SceneStatic`` holds hashable host
facts (shapes, step sizes, the cloud's tight AABB) and host copies of the
few vectors the CUDA kernels take as launch constants.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import MipmapsMode, RenderMode, SceneConfig
from .device import resolve_device
from .ops import grid as grid_ops
from .ops.phase import PhaseTable, load_phase_table


class SceneParams(NamedTuple):
    """Device-resident scene state."""

    #: [Z, Y, X] per level, f32 or uint8: views into ``mip_flat``.
    density_mips: Tuple[torch.Tensor, ...]
    inscatter: torch.Tensor  # [Z, Y, X] sun transmittance, f32 or uint8
    #: All mip levels flattened and concatenated (the descriptor kernel's
    #: input; level ``l`` starts at ``SceneStatic.mip_offsets[l]``).
    mip_flat: torch.Tensor
    bbox_size: torch.Tensor  # [3] (x, y, z), max component == 1
    light_dir: torch.Tensor  # [3] normalized, pointing *from* the sun
    light_radiance: torch.Tensor  # [3] color * intensity
    sky_intensity: torch.Tensor  # [3]
    ground_intensity: torch.Tensor  # [3]
    phase: PhaseTable
    #: [bz, by, bx] float32 dilated block occupancy (``ops.grid.build_occupancy``)
    #: where ``CloudRendering.occupancy_skipping`` is on, else empty.
    occupancy: Optional[torch.Tensor] = None
    #: ``occupancy`` as one bit a block (``ops.grid.occupancy_bits``), int32
    #: words, where it is built, else empty.
    occupancy_bits: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Host-side scene facts."""

    grid_shape: Tuple[int, int, int]  # [Z, Y, X]
    n_mips: int
    mip_shapes: Tuple[Tuple[int, int, int], ...]
    mip_offsets: Tuple[int, ...]
    sample_step: float  # in normalized bbox units (1/512)
    density_multiplier: float  # cloud_size / mean_free_path
    mode: RenderMode
    sun_cos_half_angle: float
    sun_solid_angle_ratio: float  # sun disc area / full sphere
    voxel_size_in_mfp: float
    voxel_size_normalized: float
    #: Tight bounds of nonzero density, local coordinates, one-cell margin
    #: (lo_xyz + hi_xyz).  The camera march clips to it: density outside is
    #: exactly zero.
    cloud_aabb: Tuple[float, ...]
    #: Host copies (float32 values) of bbox_size, light_dir, light_radiance,
    #: sky_intensity and ground_intensity.
    bbox: Tuple[float, float, float]
    light_direction: Tuple[float, float, float]
    light_rgb: Tuple[float, float, float]
    sky_rgb: Tuple[float, float, float]
    ground_rgb: Tuple[float, float, float]
    minimal_ray_distance: float = 1e-4
    #: Bounce cap of the path tracer (config.CloudRendering.max_depth).
    max_depth: int = 2000
    #: Russian roulette (config.CloudRendering.rr_*; 0 = off).
    rr_start_depth: int = 0
    rr_survival: float = 0.98
    #: Sky / sun light where a path leaves the box (all-scatter mode).
    sample_sky: bool = False
    #: The occupancy-block skip: cells a block edge, and the lattice steps
    #: of one step from a point whose dilated block is empty (0: off; the
    #: JAX package's rule, ``int(block / max_dim / sample_step)``, 0 below 2).
    occupancy_block: int = 8
    occupancy_skip_steps: int = 0
    #: The empty-cell exit jump: after a step into a cell whose 8 density
    #: corners are all 0 the march jumps to the last lattice step before
    #: the cell's exit face (at most 64 steps), transmittance unchanged.
    #: The JAX package's default is True; here it is False, because every
    #: bitwise gate of the port (K4 against the JAX oracle loop, K9 and
    #: K8c's replay against K4) rests on the plain step lattice, and a jump
    #: moves positions at the ulp.
    march_empty_skip: bool = False

    @property
    def max_march_steps(self) -> int:
        """Upper bound on fixed-step march steps (box diagonal)."""
        return int(math.ceil(math.sqrt(3.0) / self.sample_step)) + 4

    @property
    def max_total_steps(self) -> int:
        """Step cap of one path-traced sample: ``max_depth`` bounces of a
        mean free flight plus three steps each, and two box crossings.  A
        sample that reaches it is cut there and counts as a sample."""
        mean_segment_steps = max(
            1.0 / (self.density_multiplier * self.sample_step), 1.0
        )
        return int(
            math.ceil(self.max_depth * (mean_segment_steps + 3.0))
            + 2 * self.max_march_steps
        )


def _tight_aabb(density: np.ndarray, bbox: np.ndarray) -> Tuple[float, ...]:
    nz, ny, nx = density.shape
    nzm = density > 0.0
    if not nzm.any():
        return tuple(float(v) for v in np.concatenate([0.0 * bbox, bbox]))
    zi, yi, xi = [
        np.nonzero(nzm.any(axis=ax))[0] for ax in ((1, 2), (0, 2), (0, 1))
    ]
    dims_xyz = np.asarray([nx, ny, nz], np.float64)
    lo_idx = np.asarray([xi[0], yi[0], zi[0]], np.float64)
    hi_idx = np.asarray([xi[-1], yi[-1], zi[-1]], np.float64)
    aabb_lo = np.maximum(lo_idx - 1.0, 0.0) / dims_xyz * bbox
    aabb_hi = np.minimum(hi_idx + 2.0, dims_xyz) / dims_xyz * bbox
    return tuple(float(v) for v in np.concatenate([aabb_lo, aabb_hi]))


def _texture(m: np.ndarray, tex_u8: bool, device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(m, np.float32), device=device)
    return grid_ops.quantize_texture(t) if tex_u8 else t


def build_scene(
    cfg: SceneConfig,
    density: np.ndarray,
    inscatter: Optional[np.ndarray] = None,
    device="cuda",
) -> Tuple[SceneParams, SceneStatic]:
    """Compose the scene from config + a raw [Z, Y, X] density grid on
    ``device``: normalize, build the mip pyramid, derive bbox / density
    multiplier / voxel sizes, bind light, sky and phase state.  The
    in-scatter grid is baked separately (``render.inscatter``)."""
    dev = resolve_device(device)
    march_dtype = cfg.rendering.march_dtype
    if march_dtype not in ("float32", "uint8"):
        raise ValueError(f"march_dtype must be float32|uint8, got {march_dtype}")
    tex_u8 = march_dtype == "uint8"

    density = grid_ops.normalize_density(density)
    mips = grid_ops.build_mipmaps(density)
    if cfg.cloud.mipmaps is not MipmapsMode.ON:
        mips = mips[:1]
    nz, ny, nx = density.shape
    bbox = grid_ops.bbox_size_from_shape(density.shape)

    light_dir = np.asarray(cfg.light.direction, np.float32)
    light_dir = light_dir / np.linalg.norm(light_dir)
    light_rgb = np.asarray(cfg.light.color, np.float32) * np.float32(
        cfg.light.intensity
    )

    half_angle = math.radians(cfg.light.angular_diameter_deg) / 2.0
    sun_area = 2.0 * math.pi * (1.0 - math.cos(half_angle))
    max_dim = max(nx, ny, nz)
    voxel_size_m = cfg.cloud.size_m / max_dim
    occ_block = 8
    skip_steps = 0
    if cfg.rendering.occupancy_skipping:
        skip_steps = int(occ_block / max_dim / cfg.rendering.sample_step)
        if skip_steps < 2:
            skip_steps = 0

    mip_shapes = tuple(tuple(int(s) for s in m.shape) for m in mips)
    offsets, off = [], 0
    for s in mip_shapes:
        offsets.append(off)
        off += s[0] * s[1] * s[2]

    static = SceneStatic(
        grid_shape=(nz, ny, nx),
        n_mips=len(mips),
        mip_shapes=mip_shapes,
        mip_offsets=tuple(offsets),
        sample_step=cfg.rendering.sample_step,
        density_multiplier=cfg.density_multiplier,
        mode=cfg.rendering.mode,
        sun_cos_half_angle=math.cos(half_angle),
        sun_solid_angle_ratio=sun_area / (4.0 * math.pi),
        voxel_size_in_mfp=voxel_size_m / cfg.cloud.mean_free_path_m,
        voxel_size_normalized=1.0 / max_dim,
        cloud_aabb=_tight_aabb(np.asarray(density), bbox),
        bbox=tuple(float(v) for v in bbox),
        light_direction=tuple(float(v) for v in light_dir),
        light_rgb=tuple(float(v) for v in light_rgb),
        sky_rgb=tuple(float(v) for v in np.asarray(cfg.sky.sky_intensity, np.float32)),
        ground_rgb=tuple(float(v) for v in np.asarray(cfg.sky.ground_intensity, np.float32)),
        max_depth=cfg.rendering.max_depth,
        rr_start_depth=cfg.rendering.rr_start_depth,
        rr_survival=cfg.rendering.rr_survival,
        sample_sky=cfg.rendering.sample_sky,
        occupancy_block=occ_block,
        occupancy_skip_steps=skip_steps,
    )

    if inscatter is None:
        inscatter = np.ones(density.shape, np.float32)
    mip_flat = torch.cat([_texture(m, tex_u8, dev).reshape(-1) for m in mips])
    density_mips = tuple(
        mip_flat[o : o + s[0] * s[1] * s[2]].view(s) for o, s in zip(offsets, mip_shapes)
    )

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)

    params = SceneParams(
        density_mips=density_mips,
        inscatter=_texture(inscatter, tex_u8, dev),
        mip_flat=mip_flat,
        bbox_size=f32(bbox),
        light_dir=f32(light_dir),
        light_radiance=f32(light_rgb),
        sky_intensity=f32(cfg.sky.sky_intensity),
        ground_intensity=f32(cfg.sky.ground_intensity),
        phase=load_phase_table(dev),
        occupancy=(f32(grid_ops.build_occupancy(density, occ_block)) if skip_steps
                   else torch.zeros((0, 0, 0), dtype=torch.float32, device=dev)),
    )
    params = params._replace(occupancy_bits=grid_ops.occupancy_bits(params.occupancy))
    return params, static


def is_in_box(pos: torch.Tensor, bbox_size: torch.Tensor) -> torch.Tensor:
    """The reference's tolerant box test: pos [..., 3] in local coords
    [0, bbox] with a +-0.01 margin."""
    return torch.all((pos >= -0.01) & (pos <= bbox_size + 0.01), dim=-1)


def params_to(params: SceneParams, device) -> SceneParams:
    """A copy of the scene's tensors on ``device`` (the mip levels stay views
    of the copied ``mip_flat``): the same values, so that a kernel on one
    device and a plain version on another read the same scene."""
    dev = torch.device(device)
    flat = params.mip_flat.to(dev)
    mips, off = [], 0
    for m in params.density_mips:
        mips.append(flat[off : off + m.numel()].view(m.shape))
        off += m.numel()
    moved = {f: getattr(params, f).to(dev) for f in (
        "inscatter", "bbox_size", "light_dir", "light_radiance", "sky_intensity",
        "ground_intensity")}
    for f in ("occupancy", "occupancy_bits"):
        if getattr(params, f) is not None:
            moved[f] = getattr(params, f).to(dev)
    phase = type(params.phase)(*(t.to(dev) for t in params.phase))
    return params._replace(density_mips=tuple(mips), mip_flat=flat, phase=phase, **moved)
