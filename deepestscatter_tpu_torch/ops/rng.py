"""Stateless counter-based random numbers (PCG-RXS-M-XS mixer) and the
direction samplers of the bounce loop.

The port of ``deepestscatter_tpu.ops.rng``: ``hash_u32`` / ``hash_uniform``
bit for bit, the per-subframe seed schedule, and ``make_onb`` /
``from_onb`` / ``uniform_on_sphere_circle`` / ``uniform_on_sphere`` /
``uniform_on_disc`` (reference: random.cuh:122-174).  The hash arithmetic is uint32 modulo 2^32; it runs
here on int64 tensors masked with ``0xFFFFFFFF`` because torch's ``>>`` on
``uint32`` tensors is not implemented on every backend.  Products of two
32-bit words are split so that no intermediate leaves int64's range.  The
kernels (``csrc/common.cuh``) compute the same hash in ``uint32_t``.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF

#: Golden-ratio multiplier of the per-subframe seed schedule.
SUBFRAME_MIX = 0x9E3779B1


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


def subframe_seed(seed_base, subframe):
    """The seed of one subframe, ``seed_base ^ (subframe * 0x9E3779B1)`` in
    uint32 arithmetic: a Python int for int arguments, else an int64 tensor
    of uint32 values (``subframe`` may be a tensor of per-lane ids)."""
    if not isinstance(subframe, torch.Tensor) and not isinstance(seed_base, torch.Tensor):
        return (int(seed_base) ^ ((int(subframe) * SUBFRAME_MIX) & _MASK)) & _MASK
    dev = subframe.device if isinstance(subframe, torch.Tensor) else seed_base.device
    return _u32(seed_base, dev) ^ _mul32(_u32(subframe, dev), SUBFRAME_MIX)


def make_onb(normal: torch.Tensor):
    """Orthonormal basis (tangent, bitangent) around unit ``normal``
    [..., 3]: the branchless Frisvad-style frame of the JAX package, with
    its products in the same order."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    sign = torch.where(nz >= 0.0, torch.ones_like(nz), -torch.ones_like(nz))
    a = -1.0 / (sign + nz)
    b = (nx * ny) * a
    tangent = torch.stack(
        [1.0 + (sign * (nx * nx)) * a, sign * b, (-sign) * nx], dim=-1
    )
    bitangent = torch.stack([b, sign + (ny * ny) * a, -ny], dim=-1)
    return tangent, bitangent


def from_onb(local: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Vector from the (tangent, bitangent, normal) frame to world."""
    t, b = make_onb(normal)
    return (local[..., 0:1] * t + local[..., 1:2] * b) + local[..., 2:3] * normal


def uniform_on_sphere_circle(u: torch.Tensor, cos_theta: torch.Tensor) -> torch.Tensor:
    """Uniform azimuth ``2 pi u`` on the circle at polar angle ``cos_theta``
    around +z → [..., 3]."""
    phi = u * (2.0 * math.pi)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1
    )


def uniform_on_sphere(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Uniform direction on the unit sphere from two uniforms [...] →
    [..., 3]: azimuth ``2 pi u``, ``cos theta = 2 v - 1``."""
    phi = u * (2.0 * math.pi)
    cos_theta = 2.0 * v - 1.0
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    return torch.stack(
        [torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, cos_theta], dim=-1
    )


def uniform_on_disc(u: torch.Tensor, v: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Uniform point on the unit disc perpendicular to ``normal`` [..., 3]:
    radius ``sqrt(v)``, angle ``2 pi u``, in the (tangent, bitangent) plane
    of ``make_onb``."""
    theta = u * (2.0 * math.pi)
    sqrt_r = torch.sqrt(v)
    x = sqrt_r * torch.cos(theta)
    y = sqrt_r * torch.sin(theta)
    t, b = make_onb(normal)
    return x[..., None] * t + y[..., None] * b
