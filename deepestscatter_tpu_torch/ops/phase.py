"""Lorenz-Mie phase tables: the evaluation half of
``deepestscatter_tpu.ops.phase`` that next-event estimation reads.

``eval_rows[i] = (mie[i], mie[i+1], chopped[i], chopped[i+1])``: both phase
functions and their lerp neighbours in one row, normalized so the table mean
is 1 (``(1/4pi) integral p dOmega = 1``).  The tables come from this
package's own copy of ``assets/mie_4096.npz``.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

_ASSET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets",
    "mie_4096.npz",
)


class PhaseTable(NamedTuple):
    mie: torch.Tensor  # [N] normalized phase, indexed by (cos+1)/2
    eval_rows: torch.Tensor  # [N, 4] (mie, mie+1, chopped, chopped+1)


def _normalize_mean(table: np.ndarray) -> np.ndarray:
    return table / table.mean()


def _pack_rows(*tables: np.ndarray) -> np.ndarray:
    """Interleave tables with their +1 neighbours → [N, 2 * len(tables)]."""
    cols = []
    for t in tables:
        cols.append(t)
        cols.append(np.concatenate([t[1:], t[-1:]]))
    return np.stack(cols, axis=-1)


def load_phase_table(device) -> PhaseTable:
    """Load the Mie tables onto ``device`` as float32."""
    data = np.load(_ASSET)
    mie = _normalize_mean(data["mie_raw"])
    chopped = _normalize_mean(data["chopped_raw"])
    return PhaseTable(
        mie=torch.as_tensor(mie.astype(np.float32), device=device),
        eval_rows=torch.as_tensor(
            _pack_rows(mie, chopped).astype(np.float32), device=device
        ),
    )


def eval_phase_pair(phase: PhaseTable, cos_theta: torch.Tensor):
    """(mie, chopped) phase values at ``cos_theta`` from one row fetch."""
    n = phase.mie.shape[0]
    t = ((cos_theta + 1.0) * 0.5) * float(n) - 0.5
    t0 = torch.floor(t)
    frac = torch.where(t0 < 0.0, torch.zeros_like(t), t - t0)
    i0 = torch.clamp(t0, -1.0, float(n)).to(torch.int64).clamp(0, n - 1)
    rows = phase.eval_rows[i0]
    mie = rows[..., 0] * (1.0 - frac) + rows[..., 1] * frac
    chopped = rows[..., 2] * (1.0 - frac) + rows[..., 3] * frac
    return mie, chopped
