"""Tetrahedral barycentric interpolation over the light-probe lattice.

The port of ``deepestscatter_tpu.ops.tetra`` (reference:
DG/src/CUDA/LightProbe.cuh:57-75,137-180): each unit lattice cell splits
into 5 tetrahedra; a point takes the first of four corner tetrahedra whose
half-space test it passes (in the reference's priority order), else the
central one, and its 4 corner probes are weighted by scalar-triple-product
barycentric coordinates.

Every float expression is written out in a fixed order (cross products
component by component, sums of three terms left to right, one reciprocal
of the cell volume), so that K5 (``csrc/probes.cu``) can repeat it bitwise.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .descriptor import _cross, _dot3

#: Corner offsets of the 5 tetrahedra, in the priority order of the
#: reference's if/else chain: near (0,0,0), near (0,1,1), near (1,0,1),
#: near (1,1,0), else the central tetrahedron.
TETRA_CORNERS = np.asarray(
    [
        [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
        [[0, 1, 1], [0, 0, 1], [0, 1, 0], [1, 1, 1]],
        [[1, 0, 1], [0, 0, 1], [1, 0, 0], [1, 1, 1]],
        [[1, 1, 0], [0, 1, 0], [1, 0, 0], [1, 1, 1]],
        [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1]],
    ],
    dtype=np.float32,
)

#: The 4 corner vertices of the half-space tests, in test order.
_TEST_VERTICES = np.asarray(
    [[0, 0, 0], [0, 1, 1], [1, 0, 1], [1, 1, 0]], dtype=np.float32
)

#: The distance-to-plane threshold 1/sqrt(3) (LightProbe.cuh:128), float32.
INV_SQRT3 = float(np.float32(0.5773502691896258))


def _test_normals() -> np.ndarray:
    """[4, 3] unit normals (0.5 - v) / |0.5 - v| of the test vertices,
    float32 (|0.5 - v| = sqrt(0.75) for every vertex)."""
    n = np.float32(0.5) - _TEST_VERTICES
    norm = np.sqrt((n * n).sum(axis=-1, keepdims=True, dtype=np.float32))
    return (n / norm).astype(np.float32)


TEST_NORMALS = _test_normals()


def _sctp(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Scalar triple product (a x b) . c over [..., 3]."""
    return _dot3(_cross(a, b), c)


def barycentric(a, b, c, d, p) -> torch.Tensor:
    """Barycentric weights of ``p`` for the tetrahedron (a, b, c, d), all
    [..., 3] → [..., 4] (LightProbe.cuh:57-75)."""
    vap, vbp = p - a, p - b
    vab, vac, vad = b - a, c - a, d - a
    vbc, vbd = c - b, d - b
    va6 = _sctp(vbp, vbd, vbc)
    vb6 = _sctp(vap, vac, vad)
    vc6 = _sctp(vap, vad, vab)
    vd6 = _sctp(vap, vab, vac)
    inv = torch.reciprocal(_sctp(vab, vac, vad))
    return torch.stack([va6, vb6, vc6, vd6], dim=-1) * inv[..., None]


def select_tetrahedron(local: torch.Tensor) -> torch.Tensor:
    """Index (0..4) of the tetrahedron holding ``local`` in [0, 1)^3: the
    first corner vertex v (in test order) with ``(local - v) . n_v <
    1/sqrt(3)``, else 4 (the central tetrahedron)."""
    v = torch.as_tensor(_TEST_VERTICES, device=local.device)
    normals = torch.as_tensor(TEST_NORMALS, device=local.device)
    passes = _dot3(local[..., None, :] - v, normals) < INV_SQRT3  # [..., 4]
    idx = torch.full(local.shape[:-1], 4, dtype=torch.int32, device=local.device)
    for k in range(3, -1, -1):  # the first passing test wins
        idx = torch.where(passes[..., k], k, idx)
    return idx


def probe_interpolation(units: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner probes and weights of points in lattice units (position *
    density_multiplier / 6) → ``(corners [..., 4, 3] int32 (x, y, z),
    weights [..., 4] float32)``; the cell is ``max(floor, 0)``, the local
    position is taken before that clamp."""
    cell = torch.floor(units)
    local = units - cell
    cell = torch.clamp(cell, min=0.0).to(torch.int32)
    table = torch.as_tensor(TETRA_CORNERS, device=units.device)
    corners_local = table[select_tetrahedron(local).long()]  # [..., 4, 3]
    weights = barycentric(
        corners_local[..., 0, :],
        corners_local[..., 1, :],
        corners_local[..., 2, :],
        corners_local[..., 3, :],
        local,
    )
    corners = cell[..., None, :] + corners_local.to(torch.int32)
    return corners, weights
