"""deepestscatter_tpu_torch: the PyTorch / CUDA port of deepestscatter_tpu.

This package renders on an NVIDIA Hopper card through hand-written CUDA
kernels (``csrc/``):

- the RPNN ("Deep Scattering") neural frame: the camera march (K1,
  ``ops.march``), the descriptor stencil (K2, ``ops.descriptor``) and the
  in-scatter bake (K3, ``render.inscatter``);
- the baked light-probe ("BNN") frame (``render.baked``): K1, K2 at 9
  layers for the probe bake and at 3 for the realtime stencil, and the
  probe interpolation (K5, ``render.baked.interpolate_probes``);
- the progressive path tracer that makes the ground truth: its bounce loop
  (K4, ``render.pathtracer``) under ``render.progressive``;
- the row-gather probe (P1, P2, ``probes.gather``), the card's gather
  ceiling for the march kernels.

Each kernel's wrapper runs a plain PyTorch version on CPU tensors.

The user's entry is the command line (``python -m
deepestscatter_tpu_torch``), the render task ``tasks.render_cloud``, the
headless viewer ``render.viewer.InteractiveSession`` and the end-to-end
quality evaluation ``eval_e2e.run_eval``; ``tasks.load_neural_weights``
reads this package's trained exports or the JAX package's
(``models.flax_msgpack``).

It imports torch, numpy and the standard library only; entry points
(``build_scene``, ``bake``, ``render_disney``, ``DisneyRenderer``,
``render_baked``, ``BakedRenderer``, ``ProgressiveRenderer``,
``render_subframe``, ``trace_tick_moments``)
run on ``device="cuda"`` unless the caller passes ``device="cpu"``.
"""

from .scene import build_scene  # noqa: F401
from .render.inscatter import bake, with_baked_inscatter  # noqa: F401
from .render.neural import DisneyRenderer, render_disney  # noqa: F401
from .render.baked import BakedRenderer, render_baked  # noqa: F401
from .render.pathtracer import render_subframe, trace_tick_moments  # noqa: F401
from .render.progressive import ProgressiveRenderer  # noqa: F401
