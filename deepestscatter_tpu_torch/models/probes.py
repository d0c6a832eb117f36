"""The baked light-probe models, float32.

The port of ``deepestscatter_tpu.models.probes`` (reference:
TR/Baked/LightProbeModel.py:6-66, TR/Baked/ProbeRenderModel.py:6-66):

- ``LightProbeModel``: 9 DisneyBlocks of width 200 reading the descriptor
  layers coarse to fine (block i takes layer 8 - i, 225 samples, no angle),
  the recurrence starting at zeros; head 200 → 400 → 400 → 400 → 200 with
  ReLU x 3 and a final sigmoid, so the 200-wide latent quantizes to uint8
  for the probe lattice.
- ``ProbeRendererModel``: input layer 202 → 200 + ReLU over the
  interpolated latent with omega and alpha appended; 3 DisneyBlocks over the
  realtime descriptor layers (225 + omega = 226); head 200 → 100 → 100 → 1
  with ReLU x 2 and a final LeakyReLU (slope 0.01).

The training compositions (reference: TR/Baked/BakedModel.py:9-79,
TR/Mimic/MimicModel.py:7-43):

- ``BakedModel``: the 4 tetrahedron corners' probe descriptors folded into
  the batch through one ``LightProbeModel``, the latents weighted by the
  corners' powers and summed, omega and alpha appended, then the
  ``ProbeRendererModel``.  Its submodels are ``light_probe_model`` and
  ``renderer_model``, the renderers' two models.
- ``MimicModel``: one probe descriptor (corner "a"), no interpolation.
"""

from __future__ import annotations

import torch
from torch import nn

from .blocks import DisneyBlock, seeded_init

LIGHT_PROBE_DIMENSION = 200
LIGHT_PROBE_DIMENSION_WITH_META = LIGHT_PROBE_DIMENSION + 2
BAKED_LAYERS = 9
REALTIME_LAYERS = 3
BLOCK_DIMENSION = 200
LAYER_DIMENSION = 225
LAYER_WITH_ANGLE = LAYER_DIMENSION + 1
PROBE_HIDDEN = 400
RENDERER_HIDDEN = 100


class LightProbeModel(nn.Module):
    def __init__(self):
        super().__init__()
        self.blocks = nn.ModuleList(
            DisneyBlock(BLOCK_DIMENSION, LAYER_DIMENSION, BLOCK_DIMENSION)
            for _ in range(BAKED_LAYERS)
        )
        self.fc0 = nn.Linear(BLOCK_DIMENSION, PROBE_HIDDEN)
        self.fc1 = nn.Linear(PROBE_HIDDEN, PROBE_HIDDEN)
        self.fc2 = nn.Linear(PROBE_HIDDEN, PROBE_HIDDEN)
        self.fc3 = nn.Linear(PROBE_HIDDEN, LIGHT_PROBE_DIMENSION)

    def forward(self, z_layers: torch.Tensor) -> torch.Tensor:
        """z_layers [B, 9, 225] (no angle) → [B, 200] latent in (0, 1)."""
        if z_layers.shape[1:] != (BAKED_LAYERS, LAYER_DIMENSION):
            raise ValueError(
                f"expected [B, {BAKED_LAYERS}, {LAYER_DIMENSION}], got {tuple(z_layers.shape)}"
            )
        out = z_layers.new_zeros((z_layers.shape[0], BLOCK_DIMENSION))
        for i, block in enumerate(self.blocks):
            out = block(out, z_layers[:, BAKED_LAYERS - 1 - i, :])
        out = torch.relu(self.fc0(out))
        out = torch.relu(self.fc1(out))
        out = torch.relu(self.fc2(out))
        return torch.sigmoid(self.fc3(out))


class ProbeRendererModel(nn.Module):
    def __init__(self):
        super().__init__()
        self.input_fc = nn.Linear(LIGHT_PROBE_DIMENSION_WITH_META, BLOCK_DIMENSION)
        self.blocks = nn.ModuleList(
            DisneyBlock(BLOCK_DIMENSION, LAYER_WITH_ANGLE, BLOCK_DIMENSION)
            for _ in range(REALTIME_LAYERS)
        )
        self.fc0 = nn.Linear(BLOCK_DIMENSION, RENDERER_HIDDEN)
        self.fc1 = nn.Linear(RENDERER_HIDDEN, RENDERER_HIDDEN)
        self.fc2 = nn.Linear(RENDERER_HIDDEN, 1)

    def forward(self, light_probe: torch.Tensor, descriptor: torch.Tensor) -> torch.Tensor:
        """light_probe [B, 202] (latent, omega, alpha); descriptor [B, 3, 226]
        (realtime layers with omega) → [B, 1] predicted radiance."""
        if light_probe.shape[1:] != (LIGHT_PROBE_DIMENSION_WITH_META,):
            raise ValueError(f"expected [B, 202] probe inputs, got {tuple(light_probe.shape)}")
        if descriptor.shape[1:] != (REALTIME_LAYERS, LAYER_WITH_ANGLE):
            raise ValueError(
                f"expected [B, {REALTIME_LAYERS}, {LAYER_WITH_ANGLE}], got {tuple(descriptor.shape)}"
            )
        out = torch.relu(self.input_fc(light_probe))
        for i, block in enumerate(self.blocks):
            out = block(out, descriptor[:, i, :])
        out = torch.relu(self.fc0(out))
        out = torch.relu(self.fc1(out))
        return nn.functional.leaky_relu(self.fc2(out), negative_slope=0.01)


class BakedModel(nn.Module):
    """End-to-end two-stage composition for training."""

    def __init__(self):
        super().__init__()
        self.light_probe_model = LightProbeModel()
        self.renderer_model = ProbeRendererModel()

    def forward(
        self,
        probe_descriptors: torch.Tensor,
        probe_powers: torch.Tensor,
        disney_descriptor: torch.Tensor,
        omega: torch.Tensor,
        alpha: torch.Tensor,
    ) -> torch.Tensor:
        """probe_descriptors [B, 4, 9, 225] (tetrahedron corners), probe_powers
        [B, 4], disney_descriptor [B, 3, 226], omega and alpha [B] →
        [B, 1]."""
        b = probe_descriptors.shape[0]
        flat = probe_descriptors.reshape(b * 4, BAKED_LAYERS, LAYER_DIMENSION)
        probes = self.light_probe_model(flat).reshape(b, 4, LIGHT_PROBE_DIMENSION)
        probe = (probes * probe_powers[..., None]).sum(dim=1)
        probe = torch.cat([probe, omega[:, None], alpha[:, None]], dim=-1)
        return self.renderer_model(probe, disney_descriptor)


class MimicModel(nn.Module):
    """Single-probe experiment variant: one probe descriptor feeds the
    renderer, with no interpolation."""

    def __init__(self):
        super().__init__()
        self.light_probe_model = LightProbeModel()
        self.renderer_model = ProbeRendererModel()

    def forward(
        self,
        probe_descriptor: torch.Tensor,
        disney_descriptor: torch.Tensor,
        omega: torch.Tensor,
        alpha: torch.Tensor,
    ) -> torch.Tensor:
        """probe_descriptor [B, 9, 225], disney_descriptor [B, 3, 226], omega
        and alpha [B] → [B, 1]."""
        probe = self.light_probe_model(probe_descriptor)
        probe = torch.cat([probe, omega[:, None], alpha[:, None]], dim=-1)
        return self.renderer_model(probe, disney_descriptor)


def init_light_probe_model(seed: int, device="cuda") -> LightProbeModel:
    """A ``LightProbeModel`` with seeded random weights (``seeded_init``)."""
    return seeded_init(LightProbeModel(), seed, device)


def init_probe_renderer_model(seed: int, device="cuda") -> ProbeRendererModel:
    """A ``ProbeRendererModel`` with seeded random weights (``seeded_init``)."""
    return seeded_init(ProbeRendererModel(), seed, device)
