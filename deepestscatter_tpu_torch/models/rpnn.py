"""The Deep Scattering RPNN ("DisneyModel"), float32.

The port of ``deepestscatter_tpu.models.rpnn`` (reference:
TR/Disney/DisneyModel.py:5-58): 10 DisneyBlocks of width 200 consuming the
descriptor layers fine to coarse, with the view-to-light angle appended to
each 225-sample layer (226 inputs per block); the recurrence starts at
zeros; head 200 → 200 → 200 → 1 with ReLU x 2 and a final LeakyReLU
(slope 0.01).  Output: radiance given sun radiance 1e6.
"""

from __future__ import annotations

import torch
from torch import nn

from .blocks import DisneyBlock, seeded_init

BLOCK_DIMENSION = 200
BLOCK_COUNT = 10
LAYER_DIMENSION = 225
LAYER_WITH_ANGLE = LAYER_DIMENSION + 1


class DisneyModel(nn.Module):
    def __init__(self):
        super().__init__()
        self.blocks = nn.ModuleList(
            DisneyBlock(BLOCK_DIMENSION, LAYER_WITH_ANGLE, BLOCK_DIMENSION)
            for _ in range(BLOCK_COUNT)
        )
        self.fc0 = nn.Linear(BLOCK_DIMENSION, BLOCK_DIMENSION)
        self.fc1 = nn.Linear(BLOCK_DIMENSION, BLOCK_DIMENSION)
        self.fc2 = nn.Linear(BLOCK_DIMENSION, 1)

    def forward(self, z_layers: torch.Tensor) -> torch.Tensor:
        """z_layers [B, 10, 226] → [B, 1] predicted radiance."""
        if z_layers.shape[1:] != (BLOCK_COUNT, LAYER_WITH_ANGLE):
            raise ValueError(f"expected [B, {BLOCK_COUNT}, 226], got {tuple(z_layers.shape)}")
        out = z_layers.new_zeros((z_layers.shape[0], BLOCK_DIMENSION))
        for i, block in enumerate(self.blocks):
            out = block(out, z_layers[:, i, :])
        out = torch.relu(self.fc0(out))
        out = torch.relu(self.fc1(out))
        return nn.functional.leaky_relu(self.fc2(out), negative_slope=0.01)


def init_disney_model(seed: int, device="cuda") -> DisneyModel:
    """A ``DisneyModel`` with seeded random weights (``blocks.seeded_init``:
    every Linear uniform in +-1/sqrt(fan_in) from a ``torch.Generator``
    seeded with ``seed``) on ``device`` (the card unless the caller asks
    for the CPU; raises if there is no card)."""
    return seeded_init(DisneyModel(), seed, device)
