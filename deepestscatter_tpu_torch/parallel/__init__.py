"""Multi-device rendering and training over ``torch.distributed`` (the
port of ``deepestscatter_tpu.parallel``)."""

from .mesh import initialize_distributed, make_mesh  # noqa: F401
