"""Welford running mean / variance: the progressive estimator's statistics.

The port of ``deepestscatter_tpu.ops.welford``: the per-sample update
(progressive.cu:17-27), the exact pairwise merge (PointRadianceTask.h
operator+=, :54-68, with the between-means term), the all-reduce-able
moment triple and the 95 % CI gate.

State convention: ``mean`` is the running mean, ``m2`` the sum of squared
deviations (variance = m2 / n), ``count`` the number of samples.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device

#: float32 machine epsilon (the CI gate's relative-error floor).
F32_EPS = float(torch.finfo(torch.float32).eps)


class Welford(NamedTuple):
    mean: torch.Tensor
    m2: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def zeros(shape, dtype=torch.float32, device="cuda") -> "Welford":
        z = torch.zeros(shape, dtype=dtype, device=resolve_device(device))
        return Welford(mean=z, m2=z.clone(), count=z.clone())


def update(state: Welford, sample: torch.Tensor, mask=None) -> Welford:
    """One Welford step; ``mask`` (optional, bool) freezes masked-out
    entries."""
    new_count = state.count + 1.0
    delta = sample - state.mean
    new_mean = state.mean + delta / new_count
    new_m2 = state.m2 + delta * (sample - new_mean)
    if mask is not None:
        new_mean = torch.where(mask, new_mean, state.mean)
        new_m2 = torch.where(mask, new_m2, state.m2)
        new_count = torch.where(mask, new_count, state.count)
    return Welford(new_mean, new_m2, new_count)


def merge(a: Welford, b: Welford) -> Welford:
    """Exact pairwise merge of two partial states."""
    count = a.count + b.count
    safe = torch.clamp(count, min=1.0)
    w = b.count / safe
    mean = a.mean + (b.mean - a.mean) * w
    diff = b.mean - a.mean
    m2 = a.m2 + b.m2 + (diff * diff) * (a.count * b.count / safe)
    return Welford(mean, m2, count)


def to_moments(state: Welford):
    """(count, mean * count, raw second moment): the all-reduce-able form."""
    return (
        state.count,
        state.mean * state.count,
        state.m2 + state.count * (state.mean * state.mean),
    )


def from_moments(count, s1, s2) -> Welford:
    """Inverse of ``to_moments`` (after a sum over devices)."""
    safe = torch.clamp(count, min=1.0)
    mean = s1 / safe
    m2 = torch.clamp(s2 - safe * (mean * mean), min=0.0)
    return Welford(mean, m2, count)


def confidence_interval_95(state: Welford) -> torch.Tensor:
    """Absolute 95 % CI half-width ``1.96 sqrt(m2 / N) / sqrt(N)``
    (Camera.cpp:245-250)."""
    n = torch.clamp(state.count, min=1.0)
    sigma = torch.sqrt(state.m2 / n)
    return 1.96 * sigma / torch.sqrt(n)


def is_converged(state: Welford, rel_tol: float, abs_tol: float) -> torch.Tensor:
    """The reference's CI gate: relative < rel_tol or absolute < abs_tol,
    relative to the running mean (+ eps)."""
    abs_ci = confidence_interval_95(state)
    rel_ci = abs_ci / (state.mean + F32_EPS)
    return (rel_ci < rel_tol) | (abs_ci < abs_tol)
