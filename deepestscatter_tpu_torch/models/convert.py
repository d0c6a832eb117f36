"""Weight conversion from the JAX package's Flax models: ``DisneyModel``,
``LightProbeModel``, ``ProbeRendererModel``, and the training compositions
``BakedModel`` and ``MimicModel`` (whose Flax trees nest the two submodels
under ``light_probe_model`` and ``renderer_model``).

A Flax ``Dense`` kernel is ``[in, out]``; a torch ``Linear`` weight is
``[out, in]``, so every kernel is transposed.  The Flax parameter paths are
``block_{i}/{f1o,f1z,f2}/{kernel,bias}``, ``fc0..fc3`` and ``input_fc``;
the torch names are ``blocks.{i}.{f1o,f1z,f2}``, ``fc*`` and ``input_fc``.
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


def _convert(params: Mapping[str, Any], heads) -> Dict[str, torch.Tensor]:
    """Every ``block_{i}`` and the named ``heads`` of a Flax parameter tree
    (with or without the outer ``"params"`` key) → a torch ``state_dict``."""
    if "params" in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    i = 0
    while f"block_{i}" in params:
        for name in ("f1o", "f1z", "f2"):
            _dense(params[f"block_{i}"][name], f"blocks.{i}.{name}", out)
        i += 1
    for name in heads:
        _dense(params[name], name, out)
    return out


def disney_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``DisneyModel`` parameters → a ``state_dict`` of the torch
    ``DisneyModel``."""
    return _convert(params, ("fc0", "fc1", "fc2"))


def light_probe_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``LightProbeModel`` parameters → a ``state_dict`` of the torch
    ``LightProbeModel``."""
    return _convert(params, ("fc0", "fc1", "fc2", "fc3"))


def probe_renderer_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``ProbeRendererModel`` parameters → a ``state_dict`` of the
    torch ``ProbeRendererModel``."""
    return _convert(params, ("input_fc", "fc0", "fc1", "fc2"))


def _nested(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    if "params" in params:
        params = params["params"]
    out = {f"light_probe_model.{k}": v
           for k, v in light_probe_from_flax(params["light_probe_model"]).items()}
    out.update({f"renderer_model.{k}": v
                for k, v in probe_renderer_from_flax(params["renderer_model"]).items()})
    return out


def baked_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``BakedModel`` parameters → a ``state_dict`` of the torch
    ``BakedModel``."""
    return _nested(params)


def mimic_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``MimicModel`` parameters → a ``state_dict`` of the torch
    ``MimicModel``."""
    return _nested(params)
