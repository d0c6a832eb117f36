"""Stateless counter-based random numbers (PCG-RXS-M-XS mixer).

The port of ``deepestscatter_tpu.ops.rng.hash_u32`` / ``hash_uniform``,
bit for bit.  The arithmetic is uint32 modulo 2^32; it runs here on int64
tensors masked with ``0xFFFFFFFF`` because torch's ``>>`` on ``uint32``
tensors is not implemented on every backend.  Products of two 32-bit words
are split so that no intermediate leaves int64's range.  The march kernel
(``csrc/march.cu``) computes the same hash in ``uint32_t``.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``(a * b) mod 2^32`` for ``a`` in [0, 2^32) held as int64 and a
    constant ``b`` in [0, 2^32), without int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _u32(x, device=None) -> torch.Tensor:
    """Any integer tensor or Python int → int64 tensor of its uint32 value."""
    if not isinstance(x, torch.Tensor):
        return torch.as_tensor(int(x) & _MASK, dtype=torch.int64, device=device)
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    return x.to(torch.int64) & _MASK


def _pcg(x: torch.Tensor) -> torch.Tensor:
    """One PCG-RXS-M-XS output round over uint32 values in int64."""
    state = (_mul32(x, 747796405) + 2891336453) & _MASK
    word = _mul32(((state >> ((state >> 28) + 4)) ^ state) & _MASK, 277803737)
    return ((word >> 22) ^ word) & _MASK


def hash_u32(seed, stream, counter) -> torch.Tensor:
    """Random uint32 for (seed, stream, counter), as int64 values in
    [0, 2^32).  ``stream`` is typically a global ray id."""
    dev = stream.device if isinstance(stream, torch.Tensor) else None
    s = _u32(seed, dev)
    x = _pcg(_u32(stream, dev) ^ _mul32(s, 0x9E3779B9))
    return _pcg((x + _mul32(_u32(counter, dev), 0x85EBCA6B)) & _MASK)


def hash_uniform(seed, stream, counter) -> torch.Tensor:
    """Uniform float32 in [0, 1) with 24 bits of precision."""
    bits = hash_u32(seed, stream, counter)
    return (bits >> 8).to(torch.float32) * torch.tensor(
        1.0 / (1 << 24), dtype=torch.float32, device=bits.device
    )
