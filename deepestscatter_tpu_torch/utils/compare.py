"""Golden-image evaluation (GenerateComparisons.py parity).

The port of ``deepestscatter_tpu.utils.compare`` (reference:
TR/Utils/GenerateComparisons.py:6-65): read the path-traced ground truth
``*.PT.exr``, tone-map every render with the shared Reinhard operator,
report the RMS bias and write absolute-difference images.  Host numpy in
and out; the tone map runs in PyTorch on the CPU.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ops import tonemap as tonemap_ops
from . import exr


def tone_mapped(hdr: np.ndarray, exposure: float = 0.4) -> np.ndarray:
    """Shared display transform (reinhard.cu port) → float [0, 1]."""
    t = torch.as_tensor(np.asarray(hdr, np.float32))
    return tonemap_ops.reinhard(t, exposure).numpy()


def rms_bias(reference: np.ndarray, test: np.ndarray) -> float:
    """RMS of the tone-mapped difference (GenerateComparisons.py:32-43)."""
    a = tone_mapped(reference)
    b = tone_mapped(test)
    return float(np.sqrt(np.mean((a - b) ** 2)))


def diff_image(reference: np.ndarray, test: np.ndarray) -> np.ndarray:
    """|difference| of the tone-mapped images, for inspection."""
    return np.abs(tone_mapped(reference) - tone_mapped(test))


def compare_renders(
    pt_path: str,
    others: Sequence[str],
    out_dir: Optional[str] = None,
) -> Dict[str, float]:
    """Compare renders against the PT ground-truth EXR → {name: rms_bias};
    writes ``<name>.diff.exr`` images when ``out_dir`` is given."""
    gt = exr.read_exr(pt_path)
    out: Dict[str, float] = {}
    for path in others:
        img = exr.read_exr(path)
        name = os.path.basename(path)
        out[name] = rms_bias(gt, img)
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
            exr.write_exr(
                os.path.join(out_dir, name.replace(".exr", ".diff.exr")),
                diff_image(gt, img),
            )
    return out
