"""RPNN building blocks (the port of ``deepestscatter_tpu.models.blocks``).

``DisneyBlock`` is the residual block of the Deep Scattering RPNN
(reference: TR/Disney/DisneyBlock.py:3-31):
``out = ReLU(f2(ReLU(f1o(o) + f1z(z))) + o)``.
"""

from __future__ import annotations

import torch
from torch import nn


class DisneyBlock(nn.Module):
    def __init__(self, in_dim: int, z_dim: int, out_dim: int):
        super().__init__()
        self.f1o = nn.Linear(in_dim, out_dim)
        self.f1z = nn.Linear(z_dim, out_dim)
        self.f2 = nn.Linear(out_dim, out_dim)

    def forward(self, o: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.f1o(o) + self.f1z(z))
        return torch.relu(self.f2(h) + o)
