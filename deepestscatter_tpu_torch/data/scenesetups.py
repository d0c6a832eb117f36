"""Scene-setup seeding (GenerateSceneSetups.py).

The port of ``deepestscatter_tpu.data.scenesetups``: the same numpy RNG
draws in the same order, so the same seed gives the same records.

Reference semantics (TR/Utils/GenerateSceneSetups.py):
- glob clouds under a root (``**/*.vdb``; here also .npy/.npz and
  ``procedural:`` specs can be passed directly);
- 30 scenes per cloud (:48);
- cloud size log-uniform in [1,000, 12,000] m (:48-51);
- light direction uniform on the sphere (:11-21);
- split 70/15/15 into Train/Test/Validation **by cloud**, so no cloud leaks
  across splits (:40-45).
"""

from __future__ import annotations

import glob
import os
from typing import List, Sequence, Tuple

import numpy as np

from . import records
from .store import DatasetTriplet

SCENES_PER_CLOUD = 30
SIZE_RANGE_M = (1_000.0, 12_000.0)
SPLIT = (0.7, 0.15, 0.15)  # train, test, validation (by cloud)


def find_clouds(root: str) -> List[str]:
    out: List[str] = []
    for ext in ("vdb", "npy", "npz"):
        out.extend(sorted(glob.glob(os.path.join(root, "**", f"*.{ext}"), recursive=True)))
    return out


def make_setups(
    clouds: Sequence[str],
    rng: np.random.Generator,
    scenes_per_cloud: int = SCENES_PER_CLOUD,
) -> np.ndarray:
    """SceneSetup records for a list of clouds."""
    n = len(clouds) * scenes_per_cloud
    out = np.zeros(n, records.SCENE_SETUP)
    i = 0
    for cloud in clouds:
        for _ in range(scenes_per_cloud):
            # Log-uniform size (GenerateSceneSetups.py:48-51).
            lo, hi = np.log(SIZE_RANGE_M[0]), np.log(SIZE_RANGE_M[1])
            size = float(np.exp(rng.uniform(lo, hi)))
            # Uniform direction on the sphere (:11-21).
            phi = rng.uniform(0.0, 2.0 * np.pi)
            cos_t = rng.uniform(-1.0, 1.0)
            sin_t = np.sqrt(1.0 - cos_t**2)
            light = np.asarray(
                [np.cos(phi) * sin_t, np.sin(phi) * sin_t, cos_t], np.float32
            )
            out[i] = (cloud.encode()[: records.CLOUD_PATH_LEN], size, light)
            i += 1
    return out


def split_by_cloud(
    clouds: Sequence[str], rng: np.random.Generator
) -> Tuple[List[str], List[str], List[str]]:
    """70/15/15 split by cloud (GenerateSceneSetups.py:40-45)."""
    clouds = list(clouds)
    rng.shuffle(clouds)
    n = len(clouds)
    n_train = max(1, int(round(n * SPLIT[0]))) if n else 0
    n_test = int(round(n * SPLIT[1]))
    train = clouds[:n_train]
    test = clouds[n_train : n_train + n_test]
    val = clouds[n_train + n_test :]
    return train, test, val


def generate(
    dataset_root: str,
    clouds: Sequence[str],
    seed: int = 0,
    scenes_per_cloud: int = SCENES_PER_CLOUD,
) -> DatasetTriplet:
    """Seed SceneSetup tables of the Train/Validation/Test stores."""
    rng = np.random.default_rng(seed)
    train, test, val = split_by_cloud(clouds, rng)
    triplet = DatasetTriplet(dataset_root)
    for store, subset in (
        (triplet.train, train),
        (triplet.test, test),
        (triplet.validation, val),
    ):
        if not subset:
            continue
        setups = make_setups(subset, rng, scenes_per_cloud)
        store.table("SceneSetup").batch_append(0, setups)
    return triplet
