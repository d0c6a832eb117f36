"""deepestscatter_tpu_torch: the PyTorch / CUDA port of deepestscatter_tpu.

This package renders on an NVIDIA Hopper card through hand-written CUDA
kernels (``csrc/``):

- the RPNN ("Deep Scattering") neural frame: the camera march (K1,
  ``ops.march``), the descriptor stencil (K2, ``ops.descriptor``) and the
  in-scatter bake (K3, ``render.inscatter``);
- the progressive path tracer that makes the ground truth: its bounce loop
  (K4, ``render.pathtracer``) under ``render.progressive``;
- the row-gather probe (P1, P2, ``probes.gather``), the card's gather
  ceiling for the march kernels.

Each kernel's wrapper runs a plain PyTorch version on CPU tensors.

It imports torch, numpy and the standard library only; entry points
(``build_scene``, ``bake``, ``render_disney``, ``DisneyRenderer``,
``ProgressiveRenderer``, ``render_subframe``, ``trace_tick_moments``)
run on ``device="cuda"`` unless the caller passes ``device="cpu"``.
"""

from .scene import build_scene  # noqa: F401
from .render.inscatter import bake, with_baked_inscatter  # noqa: F401
from .render.neural import DisneyRenderer, render_disney  # noqa: F401
from .render.pathtracer import render_subframe, trace_tick_moments  # noqa: F401
from .render.progressive import ProgressiveRenderer  # noqa: F401
