"""RPNN building blocks (the port of ``deepestscatter_tpu.models.blocks``).

``DisneyBlock`` is the residual block of the Deep Scattering RPNN
(reference: TR/Disney/DisneyBlock.py:3-31):
``out = ReLU(f2(ReLU(f1o(o) + f1z(z))) + o)``.  ``seeded_init`` gives
every model of the package reproducible random weights.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_device


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
