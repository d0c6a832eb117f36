"""RPNN building blocks (the port of ``deepestscatter_tpu.models.blocks``).

``DisneyBlock`` is the residual block of the Deep Scattering RPNN
(reference: TR/Disney/DisneyBlock.py:3-31):
``out = ReLU(f2(ReLU(f1o(o) + f1z(z))) + o)``.  ``seeded_init`` gives
the renderers reproducible random weights; ``flax_init`` draws the initial
weights of training by Flax's rule; ``LogTransform`` is the trainers'
log-space target transform.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_device
from ..ops.grid import true_div

#: The standard deviation of a unit normal truncated to [-2, 2], by which
#: Flax's ``lecun_normal`` divides its scale (``variance_scaling``).
TRUNCATED_NORMAL_STD = 0.87962566103423978


class DisneyBlock(nn.Module):
    def __init__(self, in_dim: int, z_dim: int, out_dim: int):
        super().__init__()
        self.f1o = nn.Linear(in_dim, out_dim)
        self.f1z = nn.Linear(z_dim, out_dim)
        self.f2 = nn.Linear(out_dim, out_dim)

    def forward(self, o: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.f1o(o) + self.f1z(z))
        return torch.relu(self.f2(h) + o)


def seeded_init(model: nn.Module, seed: int, device="cuda") -> nn.Module:
    """``model`` with every Linear's weight and bias drawn uniform in
    +-1/sqrt(fan_in) (the PyTorch default rule) from a ``torch.Generator``
    seeded with ``seed``, on the CPU, then moved to ``device`` (the card
    unless the caller asks for the CPU; raises if there is no card)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                bound = 1.0 / math.sqrt(mod.in_features)
                for p in (mod.weight, mod.bias):
                    p.copy_((torch.rand(p.shape, generator=gen) * 2.0 - 1.0) * bound)
    return model.to(dev).eval()


def flax_init(model: nn.Module, seed: int, device="cuda") -> nn.Module:
    """``model`` with every Linear initialised by Flax's ``Dense`` default
    (``lecun_normal``, zero bias): weights from a normal truncated to +-2
    sigma with sigma = sqrt(1 / fan_in) / 0.87962566 (so their standard
    deviation is sqrt(1 / fan_in)), biases zero.  Drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` by the inverse CDF, as
    ``jax.random.truncated_normal`` draws it: the same distribution as the
    JAX package's ``model.init``, not the same values.  Then moved to
    ``device`` (the card unless the caller asks for the CPU; raises if
    there is no card)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                sigma = math.sqrt(1.0 / mod.in_features) / TRUNCATED_NORMAL_STD
                u = torch.rand(mod.weight.shape, generator=gen, dtype=torch.float64)
                x = math.sqrt(2.0) * torch.erfinv(lo + u * (hi - lo))
                mod.weight.copy_(torch.clamp(x, -2.0, 2.0) * sigma)
                mod.bias.zero_()
    return model.to(dev)


class LogTransform:
    """Log-space target transform (reference: Trainer.py LogModel.logEps,
    :27-31): ``log(max(10x + 1, 0.0099 + (10x + 1) / 100))``, smooth for x
    near 0 and defined for slightly negative x.  Divisions are IEEE
    divisions (``ops.grid.true_div``) on every device."""

    @staticmethod
    def forward(x: torch.Tensor) -> torch.Tensor:
        val = x * 1e1 + 1.0
        val = torch.maximum(val, 0.0099 + true_div(val, 100.0))
        return torch.log(val)

    @staticmethod
    def inverse(y: torch.Tensor) -> torch.Tensor:
        """Inverse on the main branch (val > 0.01): x = (exp(y) - 1) / 10."""
        return true_div(torch.exp(y) - 1.0, 10.0)
