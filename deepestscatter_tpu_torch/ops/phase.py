"""Lorenz-Mie phase tables: evaluation and inverse-CDF direction sampling.

The port of ``deepestscatter_tpu.ops.phase``.  The tables come from this
package's own copy of ``assets/mie_4096.npz`` and are built with the same
numpy code as the JAX package's, so they are bitwise equal to its tables:

- ``mie`` / ``chopped``: the phase functions normalized so the table mean
  is 1 (``(1/4pi) integral p dOmega = 1``), indexed by ``(cos + 1) / 2``;
- ``chopped_cdf``: the running normalized sum of the chopped phase;
- ``eval_rows[i] = (mie[i], mie[i+1], chopped[i], chopped[i+1])``: both
  phase functions and their lerp neighbours in one row;
- ``inv_cdf_rows[j] = (m_j, m_{j+1})``: the chopped CDF inverted offline
  onto 16384 uniform steps of ``u``, so a direction sample is one row and a
  lerp (``sample_cos_theta_fast``, the bounce loop's sampler).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .grid import true_div

_ASSET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets",
    "mie_4096.npz",
)

#: Rows of the inverse-CDF table (the JAX package's default).
INV_CDF_SIZE = 16384


class PhaseTable(NamedTuple):
    mie: torch.Tensor  # [N] normalized phase, indexed by (cos+1)/2
    chopped: torch.Tensor  # [N] normalized chopped phase
    chopped_cdf: torch.Tensor  # [N] CDF of the chopped phase
    eval_rows: torch.Tensor  # [N, 4] (mie, mie+1, chopped, chopped+1)
    inv_cdf_rows: torch.Tensor  # [M, 2] inverse CDF (value, next)


def _normalize_mean(table: np.ndarray) -> np.ndarray:
    return table / table.mean()


def _build_cdf(table: np.ndarray) -> np.ndarray:
    """Running normalized sum: ``cdf[i] = sum(table[:i+1]) / sum(table)``
    (reference: getIntegralSampler, Mie.cpp:8245-8282)."""
    return np.cumsum(table / table.sum())


def _invert_cdf(cdf: np.ndarray, m_samples: int) -> np.ndarray:
    """``m(u)`` solving ``tex1D(cdf, m) = u`` on a uniform grid of ``u``:
    ``tex1D(cdf, .)`` is piecewise linear with nodes at ``(i + 0.5) / n``
    and flat beyond the end nodes."""
    n = cdf.shape[0]
    nodes = (np.arange(n) + 0.5) / n
    u = (np.arange(m_samples) + 0.5) / m_samples
    m = np.interp(u, cdf, nodes, left=nodes[0], right=nodes[-1])
    return m.astype(np.float32)


def _pack_rows(*tables: np.ndarray) -> np.ndarray:
    """Interleave tables with their +1 neighbours → [N, 2 * len(tables)]."""
    cols = []
    for t in tables:
        cols.append(t)
        cols.append(np.concatenate([t[1:], t[-1:]]))
    return np.stack(cols, axis=-1)


def load_phase_table(device, inv_cdf_size: int = INV_CDF_SIZE) -> PhaseTable:
    """Load the Mie tables onto ``device`` as float32."""
    data = np.load(_ASSET)
    mie = _normalize_mean(data["mie_raw"])
    chopped = _normalize_mean(data["chopped_raw"])
    cdf = _build_cdf(data["chopped_raw"])
    inv = _invert_cdf(cdf, inv_cdf_size)

    def f32(a):
        return torch.as_tensor(np.asarray(a).astype(np.float32), device=device)

    return PhaseTable(
        mie=f32(mie),
        chopped=f32(chopped),
        chopped_cdf=f32(cdf),
        eval_rows=f32(_pack_rows(mie, chopped)),
        inv_cdf_rows=f32(_pack_rows(inv)),
    )


def _row_index(t: torch.Tensor, n: int):
    """Lerp cell of ``t = u * n - 0.5``: index clipped to [0, n-1] (clamped
    in float first, so inf or far-out values cannot overflow), fraction 0
    below the first node."""
    t0 = torch.floor(t)
    frac = torch.where(t0 < 0.0, torch.zeros_like(t), t - t0)
    i0 = torch.clamp(t0, -1.0, float(n)).to(torch.int64).clamp(0, n - 1)
    return i0, frac


def eval_phase(table: torch.Tensor, cos_theta: torch.Tensor) -> torch.Tensor:
    """Phase value at ``cos_theta``: CUDA ``tex1D`` with normalized
    coordinates, linear filter, clamp to edge (reference: cloud.cuh:47-56)."""
    n = table.shape[0]
    t = ((cos_theta + 1.0) * 0.5) * float(n) - 0.5
    t0 = torch.floor(t)
    frac = t - t0
    i0 = torch.clamp(t0, -1.0, float(n)).to(torch.int64).clamp(0, n - 1)
    i1 = torch.clamp(i0 + 1, max=n - 1)
    return table[i0] * (1.0 - frac) + table[i1] * frac


def eval_phase_pair(phase: PhaseTable, cos_theta: torch.Tensor):
    """(mie, chopped) phase values at ``cos_theta`` from one row fetch."""
    n = phase.mie.shape[0]
    i0, frac = _row_index(((cos_theta + 1.0) * 0.5) * float(n) - 0.5, n)
    rows = phase.eval_rows[i0]
    mie = rows[..., 0] * (1.0 - frac) + rows[..., 1] * frac
    chopped = rows[..., 2] * (1.0 - frac) + rows[..., 3] * frac
    return mie, chopped


def sample_cos_theta(phase: PhaseTable, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF sample of the scatter cosine, solved exactly in the
    bracketing texel of the chopped CDF (the reference bisects 16 times,
    cloud.cuh:160-188)."""
    cdf = phase.chopped_cdf
    n = cdf.shape[0]
    i1 = torch.searchsorted(cdf, u.contiguous(), side="left").clamp(0, n - 1)
    i0 = torch.clamp(i1 - 1, min=0)
    c0 = cdf[i0]
    c1 = cdf[i1]
    denom = torch.clamp(c1 - c0, min=1e-20)
    frac = torch.clamp((u - c0) / denom, 0.0, 1.0)
    m = true_div(i0.to(u.dtype) + 0.5 + frac * (i1 - i0).to(u.dtype), float(n))
    m = torch.where(u <= cdf[0], torch.full_like(m, 0.5 / n), m)
    m = torch.where(u >= cdf[-1], torch.full_like(m, (n - 0.5) / n), m)
    return 2.0 * m - 1.0


def sample_cos_theta_fast(phase: PhaseTable, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF scatter cosine from the precomputed inverse table: one
    row and a lerp (accurate to one part in ``INV_CDF_SIZE`` of ``u``)."""
    inv = phase.inv_cdf_rows
    m_size = inv.shape[0]
    i0, frac = _row_index(u * float(m_size) - 0.5, m_size)
    rows = inv[i0]
    m = rows[..., 0] * (1.0 - frac) + rows[..., 1] * frac
    return 2.0 * m - 1.0
