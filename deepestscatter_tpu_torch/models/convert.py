"""Weight conversion from the JAX package's Flax ``DisneyModel``.

A Flax ``Dense`` kernel is ``[in, out]``; a torch ``Linear`` weight is
``[out, in]``, so every kernel is transposed.  The Flax parameter paths are
``block_{i}/{f1o,f1z,f2}/{kernel,bias}`` and ``fc0..fc2``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _dense(tree: Mapping[str, Any], prefix: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{prefix}.weight"] = torch.from_numpy(
        np.array(np.asarray(tree["kernel"], np.float32).T)
    )
    out[f"{prefix}.bias"] = torch.from_numpy(np.array(tree["bias"], np.float32))


def disney_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``DisneyModel`` parameters (numpy arrays, with or without the
    outer ``"params"`` key) → a ``state_dict`` of the torch ``DisneyModel``."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    i = 0
    while f"block_{i}" in params:
        for name in ("f1o", "f1z", "f2"):
            _dense(params[f"block_{i}"][name], f"blocks.{i}.{name}", out)
        i += 1
    for name in ("fc0", "fc1", "fc2"):
        _dense(params[name], name, out)
    return out
