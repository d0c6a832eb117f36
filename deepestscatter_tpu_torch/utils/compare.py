"""Golden-image evaluation (GenerateComparisons.py parity).

The port of ``deepestscatter_tpu.utils.compare`` (reference:
TR/Utils/GenerateComparisons.py:6-65): read the path-traced ground truth
``*.PT.exr``, tone-map every render with the shared Reinhard operator,
report the RMS bias and write absolute-difference images.  Host numpy in
and out; the tone map runs in PyTorch on the CPU.

``render_agreement`` holds a progressive render (its per-pixel Welford
state, or several pooled by ``pool_renders``) against a reference image
with a statistical gate: the port's converged path-traced image against
the JAX package's committed one; ``paired_difference`` holds a render of
the reference's own seed against it.
"""

from __future__ import annotations

import os
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

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


#: The gate of ``Agreement.passes``: the image means within Z_MAX standard
#: errors, the tone-mapped RMS at most RMS_RATIO times the noise's.
Z_MAX = 4.0
RMS_RATIO = 1.5


class Agreement(NamedTuple):
    """A render against a reference image (``render_agreement``)."""

    mean: float  # the render's image mean
    reference_mean: float
    mean_se: float  # standard error of the difference of the two image means
    mean_z: float  # (mean - reference_mean) / mean_se
    rms: float  # rms_bias(reference, render)
    noise_rms: float  # the tone-mapped RMS the two renders' noise alone gives
    past_4_sigma: float  # share of noisy pixel channels more than 4 sigma apart

    def passes(self) -> bool:
        """The gate: ``|mean_z| <= Z_MAX`` and ``rms <= RMS_RATIO * noise_rms``."""
        return abs(self.mean_z) <= Z_MAX and self.rms <= RMS_RATIO * self.noise_rms


def paired_difference(image: np.ndarray, reference: np.ndarray) -> Tuple[float, float]:
    """Two [H, W, 3] images of the same paths (one seed, where two float
    libraries parted some of them) → (the difference of their means, its
    standard error from the spread of the per-pixel differences of the
    channel means; pixels are independent)."""
    d = (np.asarray(image, np.float64) - np.asarray(reference, np.float64)).mean(axis=-1)
    return float(d.mean()), float(d.std(ddof=1) / np.sqrt(d.size))


def pool_renders(renders: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]]):
    """Welford states ``(mean [H, W, 3], m2 [H, W, 3], count [H, W])`` of
    independent renders of one image → the state of all their samples
    (Chan's merge, float64)."""
    mean = np.zeros(np.shape(renders[0][0]), np.float64)
    m2 = np.zeros_like(mean)
    n = np.zeros(mean.shape[:2] + (1,), np.float64)
    for r_mean, r_m2, r_count in renders:
        nb = np.asarray(r_count, np.float64).reshape(n.shape)
        tot = n + nb
        delta = np.asarray(r_mean, np.float64) - mean
        w = np.where(tot > 0.0, nb / np.maximum(tot, 1.0), 0.0)
        m2 = m2 + np.asarray(r_m2, np.float64) + delta**2 * n * w
        mean = mean + delta * w
        n = tot
    return mean, m2, n[..., 0]


def render_agreement(mean: np.ndarray, m2: np.ndarray, count: np.ndarray,
                     reference: np.ndarray, reference_noise: float = 1.0) -> Agreement:
    """A progressive render's Welford state (``mean``, ``m2`` [H, W, 3],
    ``count`` [H, W] or [H, W, 1] samples a pixel) against ``reference``
    [H, W, 3].

    A pixel channel's standard error is sqrt(m2 / (n (n - 1))) (0 where
    n < 2).  The reference's is taken as ``reference_noise`` times the
    render's: sqrt(n / n_ref) for a reference of n_ref samples a pixel
    against a render (or a pool, ``pool_renders``) of n; 0 for a reference
    whose noise is negligible.  So a difference has the variance
    (1 + reference_noise^2) se^2.  A pixel's three channels come from the
    same paths, so their errors are taken as perfectly correlated: the
    standard error of a pixel's channel mean is the mean of its channels'
    (the largest the moments allow; exact where the channels deviate
    together, as the path tracer's do, whose m2 is equal in the three).
    Pixels are independent.  ``mean_se`` is the standard error of the
    difference of the image means; ``noise_rms`` is the tone-mapped RMS
    between the render plus one draw of its noise and the render plus one
    draw of the reference's (numpy's ``default_rng(0)``, Gaussian, one
    draw a pixel for its three channels, each image clamped at 0: radiance
    is not negative).  The tone map divides by the image's mean luminance,
    so the RMS does not see a scale of the whole image; the mean's z-score
    does.  ``past_4_sigma`` the share of pixel channels with se > 0 whose
    difference exceeds 4 of its standard deviations."""
    mean = np.asarray(mean, np.float64)
    ref = np.asarray(reference, np.float64)
    n = np.asarray(count, np.float64).reshape(mean.shape[:2] + (1,))
    var = np.where(n >= 2.0, np.asarray(m2, np.float64) / np.maximum(n * (n - 1.0), 1.0), 0.0)
    var = np.maximum(var, 0.0)
    k = 1.0 + reference_noise**2
    se = np.sqrt(var)
    pixel_se = se.mean(axis=-1)
    mean_se = float(np.sqrt(k * (pixel_se**2).sum()) / pixel_se.size)
    diff = float(mean.mean() - ref.mean())
    noisy = var > 0.0
    past = float((np.abs(mean - ref)[noisy] > 4.0 * np.sqrt(k * var[noisy])).mean()
                 if noisy.any() else 0.0)
    rng = np.random.default_rng(0)
    draw = mean.shape[:2] + (1,)
    a = np.maximum(mean + se * rng.standard_normal(draw), 0.0).astype(np.float32)
    b = np.maximum(mean + reference_noise * se * rng.standard_normal(draw),
                   0.0).astype(np.float32)
    return Agreement(
        mean=float(mean.mean()), reference_mean=float(ref.mean()), mean_se=mean_se,
        mean_z=diff / mean_se if mean_se > 0.0 else (0.0 if diff == 0.0 else float("inf")),
        rms=rms_bias(np.asarray(reference, np.float32), mean.astype(np.float32)),
        noise_rms=rms_bias(a, b), past_4_sigma=past)
