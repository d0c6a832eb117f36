"""Density grids, mip pyramids and trilinear sampling.

The port of ``deepestscatter_tpu.ops.grid``.  Grids are raw ``[Z, Y, X]``
tensors (x fastest), float32 in [0, 1] or uint8 textures storing
``round(v * 255)``.  The JAX package packs each voxel's eight cell corners
into one row (a TPU gather-rate layout); the values sampled here are those
of its packed path, whose clamp rule differs from plain clamp-to-edge
below zero:

- ``t = u * N - 0.5``, ``t0 = floor(t)``; ``frac = 0`` where ``t0 < 0``;
- the cell index is ``clip(t0, 0, N - 1)`` and its ``+1`` corner is clamped
  to ``N - 1``;
- uint8 values dequantize as ``float(v) * float32(1/255)`` before weighting;
- the eight corner weights are ``(wz * wy) * wx`` in corner order
  ``cx + 2 cy + 4 cz``, summed in that order.

The CUDA kernels (``csrc/common.cuh``) compute the same sums in the same
order, so this module is their plain version as well as the CPU path.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

#: float32(1/255): the uint8 texture dequantization factor.
U8_SCALE = float(np.float32(1.0 / 255.0))


def build_mipmaps(density: np.ndarray, dtype=np.float32) -> Tuple[np.ndarray, ...]:
    """The full mip pyramid down to 1x1x1 with an 8-tap box filter (host
    numpy, float64 accumulation; odd sizes clamp the +1 tap)."""
    density = np.asarray(density, dtype=np.float32)
    if density.ndim != 3:
        raise ValueError(f"density grid must be [Z, Y, X], got {density.shape}")
    levels = [density]
    current = density
    while current.shape != (1, 1, 1):
        nz, ny, nx = current.shape
        sz, sy, sx = (max(1, (nz + 1) // 2), max(1, (ny + 1) // 2), max(1, (nx + 1) // 2))
        iz = np.minimum(2 * np.arange(sz), nz - 1)
        iy = np.minimum(2 * np.arange(sy), ny - 1)
        ix = np.minimum(2 * np.arange(sx), nx - 1)
        iz1 = np.minimum(iz + 1, nz - 1)
        iy1 = np.minimum(iy + 1, ny - 1)
        ix1 = np.minimum(ix + 1, nx - 1)
        acc = np.zeros((sz, sy, sx), dtype=np.float64)
        for z in (iz, iz1):
            for y in (iy, iy1):
                for x in (ix, ix1):
                    acc += current[np.ix_(z, y, x)]
        current = (acc / 8.0).astype(np.float32)
        levels.append(current)
    return tuple(lvl.astype(dtype) for lvl in levels)


def normalize_density(raw: np.ndarray) -> np.ndarray:
    """Normalize a raw density grid by its max, clipped to [0, 1]."""
    raw = np.asarray(raw, dtype=np.float32)
    m = float(raw.max())
    if m > 0:
        raw = raw / m
    return np.clip(raw, 0.0, 1.0)


def bbox_size_from_shape(shape: Tuple[int, int, int]) -> np.ndarray:
    """Normalized bbox size with the longest side == 1; shape is [Z, Y, X],
    the result is (x, y, z)."""
    nz, ny, nx = shape
    m = float(max(nx, ny, nz))
    return np.asarray([nx / m, ny / m, nz / m], dtype=np.float32)


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded as an IEEE division.  PyTorch on CUDA turns a
    division by a Python scalar into a multiplication by its reciprocal,
    which can differ in the last bit from the kernels' division; a 0-dim
    tensor on ``a``'s device keeps the true division."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def quantize_texture(m: torch.Tensor) -> torch.Tensor:
    """The uint8 texture quantizer ``round(clip(m, 0, 1) * 255)``: values a
    hair outside [0, 1] saturate instead of wrapping."""
    return torch.round(torch.clamp(m.to(torch.float32), 0.0, 1.0) * 255.0).to(
        torch.uint8
    )


def _axis_cell(t: torch.Tensor, n: int):
    """Packed-path cell index and fraction along one axis."""
    t0 = torch.floor(t)
    frac = torch.where(t0 < 0.0, torch.zeros_like(t), t - t0)
    # Clamp in float first: positions far outside the grid (or inf) must not
    # overflow the integer conversion.
    i0 = torch.clamp(t0, -1.0, float(n)).to(torch.int64).clamp(0, n - 1)
    i1 = torch.clamp(i0 + 1, max=n - 1)
    return i0, i1, frac


def sample_trilinear(grid: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of a ``[Z, Y, X]`` grid at normalized coordinates
    ``u`` [..., 3] (x, y, z order), with the packed path's clamp rule.
    Returns float32 [...]."""
    nz, ny, nx = grid.shape
    x0, x1, fx = _axis_cell(u[..., 0] * float(nx) - 0.5, nx)
    y0, y1, fy = _axis_cell(u[..., 1] * float(ny) - 0.5, ny)
    z0, z1, fz = _axis_cell(u[..., 2] * float(nz) - 0.5, nz)
    flat = grid.reshape(-1)

    def tap(z, y, x):
        v = flat[(z * ny + y) * nx + x]
        if grid.dtype == torch.uint8:
            return v.to(torch.float32) * U8_SCALE
        return v

    wx = (1.0 - fx, fx)
    wy = (1.0 - fy, fy)
    wz = (1.0 - fz, fz)
    zs, ys, xs = (z0, z1), (y0, y1), (x0, x1)
    acc = None
    for k in range(8):
        cx, cy, cz = k & 1, (k >> 1) & 1, k >> 2
        term = tap(zs[cz], ys[cy], xs[cx]) * ((wz[cz] * wy[cy]) * wx[cx])
        acc = term if acc is None else acc + term
    return acc


def mip_lerp_levels(n_levels: int, lod: float):
    """Static level selection of ``sample_mip``: ``(lo, hi, w_lo, w_hi,
    use_hi)`` with the LOD clamped to [0, n_levels - 1].  The weights are
    the float32 values of the host-side doubles ``1 - frac`` and ``frac``."""
    lod = float(min(max(lod, 0.0), n_levels - 1))
    lo = int(np.floor(lod))
    hi = min(lo + 1, n_levels - 1)
    frac = lod - lo
    use_hi = not (frac == 0.0 or lo == hi)
    return lo, hi, float(np.float32(1.0 - frac)), float(np.float32(frac)), use_hi


def sample_mip(mips: Sequence[torch.Tensor], u: torch.Tensor, lod: float) -> torch.Tensor:
    """Linear-mipmap-linear sample of a pyramid at a static fractional LOD
    (``rtTex3DLod`` with linear mip filtering)."""
    lo, hi, w_lo, w_hi, use_hi = mip_lerp_levels(len(mips), lod)
    lo_val = sample_trilinear(mips[lo], u)
    if not use_hi:
        return lo_val
    hi_val = sample_trilinear(mips[hi], u)
    return lo_val * w_lo + hi_val * w_hi
