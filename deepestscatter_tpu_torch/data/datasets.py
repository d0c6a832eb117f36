"""Training datasets: ``DisneyDataset`` and ``BakedDataset``, batch-native.

The port of ``deepestscatter_tpu.data.datasets`` (reference:
DisneyDataset.py, BakedDataset.py, BaseDataset.py).  Whole batches are
gathered from the record store's tables as numpy arrays (sorted indices,
native point gathers), no per-item work.

- Disney item: descriptor [10, 225] / 256 with omega appended → [10, 226];
  label = ``Result.light_intensity``; converged labels only
  (DisneyDataset.py:32-41).
- Baked item: the 4 corners' probe descriptors [9, 225] / 256, their 4
  powers, the realtime descriptor [3, 225] / 256 + omega → [3, 226], omega,
  alpha (BakedDataset.py:16-69).
- Length = min(count(main table), count(Result)) (BaseDataset.py:20-24).

``_omega`` is numpy, bitwise the JAX package's; ``_alpha`` runs the port's
``ops.descriptor.alpha_angle`` on CPU tensors (the renderer's angle).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from ..models.probes import BAKED_LAYERS, REALTIME_LAYERS
from ..ops import descriptor as desc_ops
from .store import RecordStore


def _omega(light: np.ndarray, view: np.ndarray) -> np.ndarray:
    """angleBetween(light, view) (Vector.py:18-19), batched."""
    ln = light / np.linalg.norm(light, axis=-1, keepdims=True)
    vn = view / np.linalg.norm(view, axis=-1, keepdims=True)
    return np.arccos(np.clip((ln * vn).sum(-1), -1.0, 1.0)).astype(np.float32)


def _alpha(light: np.ndarray, view: np.ndarray, probe_dir: np.ndarray) -> np.ndarray:
    """Signed descriptor-basis angle (BakedDataset.py:56-69), batched, per
    row's light."""
    return desc_ops.alpha_angle(
        torch.from_numpy(np.ascontiguousarray(light, np.float32)),
        torch.from_numpy(np.ascontiguousarray(view, np.float32)),
        torch.from_numpy(np.ascontiguousarray(probe_dir, np.float32)),
    ).numpy()


class _Base:
    def __init__(self, store: RecordStore, main_table: str):
        self.store = store
        self.main_table = main_table
        self._scene_cache: Dict[int, np.void] = {}

    def __len__(self) -> int:
        return min(self.store.count(self.main_table), self.store.count("Result"))

    def _scene_light(self, scene_ids: np.ndarray) -> np.ndarray:
        """Light directions of each sample's SceneSetup (cached per scene)."""
        out = np.zeros((len(scene_ids), 3), np.float32)
        table = self.store.table("SceneSetup")
        for i, sid in enumerate(scene_ids):
            sid = int(sid)
            if sid not in self._scene_cache:
                self._scene_cache[sid] = table.get_record(sid)
            out[i] = self._scene_cache[sid]["light_direction"]
        return out

    def batches(self, batch: int, seed: int) -> Iterator[Tuple[dict, np.ndarray]]:
        """A shuffled epoch of batches (``np.random.default_rng(seed)``), each
        batch's indices sorted; unconverged labels dropped (the reference
        asserts convergence per item, DisneyDataset.py:41)."""
        n = len(self)
        order = np.random.default_rng(seed).permutation(n)
        for s in range(0, n - batch + 1, batch):
            idx = np.sort(order[s : s + batch])
            item, labels, ok = self._gather(idx)
            item = {k: v[ok] for k, v in item.items()}
            labels = labels[ok]
            if len(labels):
                yield item, labels


class DisneyDataset(_Base):
    """RPNN training items (DisneyDataset.py:8-43)."""

    def __init__(self, store: RecordStore):
        super().__init__(store, "DisneyDescriptor")

    def _gather(self, idx: np.ndarray):
        grids = self.store.table("DisneyDescriptor").gather(idx)["grid"]
        samples = self.store.table("ScatterSample").gather(idx)
        results = self.store.table("Result").gather(idx)
        light = self._scene_light(samples["scene_setup_id"])
        view = samples["view_direction"].astype(np.float32)
        omega = _omega(light, view)
        desc = grids.reshape(-1, 10, 225).astype(np.float32) / 256.0
        z = np.concatenate(
            [desc, np.broadcast_to(omega[:, None, None], (len(idx), 10, 1))], axis=-1
        )
        return (
            {"z_layers": z},
            results["light_intensity"].astype(np.float32),
            results["is_converged"].astype(bool),
        )


class BakedDataset(_Base):
    """Two-stage model training items (BakedDataset.py:8-75)."""

    def __init__(self, store: RecordStore):
        super().__init__(store, "BakedInterpolationSet")

    def _gather(self, idx: np.ndarray):
        sets = self.store.table("BakedInterpolationSet").gather(idx)
        disney = self.store.table("DisneyDescriptor").gather(idx)["grid"]
        samples = self.store.table("ScatterSample").gather(idx)
        results = self.store.table("Result").gather(idx)
        light = self._scene_light(samples["scene_setup_id"])
        view = samples["view_direction"].astype(np.float32)
        n = len(idx)
        probe_desc = np.stack(
            [sets[c]["grid"].reshape(n, 10, 225)[:, :BAKED_LAYERS] for c in "abcd"],
            axis=1,
        ).astype(np.float32) / 256.0  # [n, 4, L, 225]
        powers = np.stack([sets[c]["power"] for c in "abcd"], axis=1).astype(np.float32)
        omega = _omega(light, view)
        alpha = _alpha(light, view, sets["a"]["direction"].astype(np.float32))
        rt = disney.reshape(n, 10, 225)[:, :REALTIME_LAYERS].astype(np.float32) / 256.0
        rt = np.concatenate(
            [rt, np.broadcast_to(omega[:, None, None], (n, REALTIME_LAYERS, 1))],
            axis=-1,
        )
        item = {
            "probe_descriptors": probe_desc,
            "probe_powers": powers,
            "disney_descriptor": rt,
            "omega": omega,
            "alpha": alpha,
        }
        return (
            item,
            results["light_intensity"].astype(np.float32),
            results["is_converged"].astype(bool),
        )
