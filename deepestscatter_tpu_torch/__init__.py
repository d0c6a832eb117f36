"""deepestscatter_tpu_torch: the PyTorch / CUDA port of deepestscatter_tpu.

This package renders the RPNN ("Deep Scattering") neural frame on an
NVIDIA Hopper card through hand-written CUDA kernels (``csrc/``): the
camera march (K1, ``ops.march``), the descriptor stencil (K2,
``ops.descriptor``) and the in-scatter bake (K3, ``render.inscatter``).
Each kernel's wrapper runs a plain PyTorch version on CPU tensors.

It imports torch, numpy and the standard library only; entry points
(``build_scene``, ``bake``, ``render_disney``, ``DisneyRenderer``) run on
``device="cuda"`` unless the caller passes ``device="cpu"``.
"""

from .scene import build_scene  # noqa: F401
from .render.inscatter import bake, with_baked_inscatter  # noqa: F401
from .render.neural import DisneyRenderer, render_disney  # noqa: F401
