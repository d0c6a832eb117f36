"""Device selection for the package's entry points.

Entry points run on the card unless the caller asks for the CPU.  A CUDA
request on a host without a usable card raises; nothing falls back.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run on the CPU"
        )
    return dev


def check_on(device: torch.device, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on ``device``."""
    for t in tensors:
        if t.device.type != device.type or (
            device.index is not None and t.device.index != device.index
        ):
            raise ValueError(
                f"tensor on {t.device} but the call runs on {device}"
            )
