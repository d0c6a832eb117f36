"""Next-event estimation toward the sun (the part of
``deepestscatter_tpu.render.pathtracer`` the neural frame reads).

The march kernel (``csrc/march.cu``) fuses this into its epilogue; this is
its plain version.
"""

from __future__ import annotations

import torch

from ..ops import grid as grid_ops
from ..ops import phase as phase_ops
from ..scene import SceneParams, SceneStatic
from .camera import cos_to_sun


def sample_inscatter(params: SceneParams, pos: torch.Tensor) -> torch.Tensor:
    """Baked sun transmittance at local positions ``pos`` [..., 3]."""
    return grid_ops.sample_trilinear(params.inscatter, pos / params.bbox_size)


def in_scattering(
    params: SceneParams,
    static: SceneStatic,
    scatter_pos: torch.Tensor,
    direction: torch.Tensor,
) -> torch.Tensor:
    """Light radiance x baked sun transmittance x full Mie phase x sun
    solid-angle ratio (cloud.cuh:146-158) → [N, 3]; the JAX function with
    ``chopped=False``, as the neural camera calls it."""
    p, _ = phase_ops.eval_phase_pair(
        params.phase, cos_to_sun(params.light_dir, direction)
    )
    trans_sun = sample_inscatter(params, scatter_pos)
    scale = p * trans_sun * static.sun_solid_angle_ratio
    return params.light_radiance * scale[..., None]
