"""Reinhard tone mapping (reference: DG/src/CUDA/reinhard.cu:26-84).

The port of ``deepestscatter_tpu.ops.tonemap``: the reference's three
launches (luminance sums, global average, per-pixel map) are one
reduction and one elementwise pass of PyTorch ops.
"""

from __future__ import annotations

import torch

#: Luminance weights (reinhard.cu:20-23).
LUMA = (0.265068, 0.67023428, 0.06409157)
_DELTA = 1e-5


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    w = torch.tensor(LUMA, dtype=rgb.dtype, device=rgb.device)
    return (rgb * w).sum(dim=-1)


def average_luminance(rgb: torch.Tensor) -> torch.Tensor:
    """Plain (not log) average of luminance + DELTA per pixel, as the
    reference takes it (reinhard.cu:37-39)."""
    return (luminance(rgb) + _DELTA).mean()


def reinhard(rgb: torch.Tensor, exposure: float, avg_luminance=None) -> torch.Tensor:
    """Linear HDR [H, W, 3] → display [0, 1] with gamma 1/2.2."""
    if avg_luminance is None:
        avg_luminance = average_luminance(rgb)
    lw = luminance(rgb)
    ld = lw * exposure / avg_luminance
    ld = ld / (1.0 + ld)
    scale = ld / torch.clamp(lw, min=torch.finfo(rgb.dtype).tiny)
    out = torch.clamp(rgb * scale[..., None], 0.0, 1.0)
    return out ** (1.0 / 2.2)


def to_uint8(display_rgb: torch.Tensor) -> torch.Tensor:
    """[0, 1] float → uint8, truncating like the uchar4 cast in
    reinhard.cu:81."""
    return (display_rgb * 255.0).to(torch.uint8)
