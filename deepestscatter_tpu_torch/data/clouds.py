"""Cloud density loading (Resources::loadVolumeBuffer).

The port of ``deepestscatter_tpu.data.clouds``.  Sources:

- ``procedural:<resolution>:<seed>``: the deterministic synthetic cumulus
  (``data.procedural``);
- ``*.npy`` / ``*.npz``: dense [Z, Y, X] grids (``npz`` key ``density``,
  else its first array);
- ``*.vdb``: the ``<path>.npz`` converted beside it where there is one,
  else the file itself through the package's OpenVDB-subset reader
  (``data/vdb.py``; uncompressed, zlib- and blosc1-compressed archives,
  ``data/blosc1.py``).

``prepare`` normalizes by the maximum (Resources.cpp:93-96) and pads one
zero voxel a side (Resources.cpp:89-91).
"""

from __future__ import annotations

import os

import numpy as np

from ..ops import grid as grid_ops
from . import procedural


def load_density(path: str) -> np.ndarray:
    """Raw [Z, Y, X] density from any supported source."""
    if path.startswith("procedural:"):
        parts = path.split(":")
        resolution = int(parts[1]) if len(parts) > 1 else 64
        seed = int(parts[2]) if len(parts) > 2 else 0
        return procedural.cumulus(resolution=resolution, seed=seed)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return np.load(path)
    if ext == ".npz":
        data = np.load(path)
        key = "density" if "density" in data else list(data.keys())[0]
        return data[key]
    if ext == ".vdb":
        npz = path + ".npz"
        if os.path.exists(npz):
            return load_density(npz)
        from . import vdb as vdb_mod

        return vdb_mod.load_density_vdb(path)
    raise ValueError(f"unsupported cloud source: {path}")


def prepare(raw: np.ndarray, pad: int = 1) -> np.ndarray:
    """Normalize by the maximum and add a ``pad``-voxel zero boundary."""
    return grid_ops.pad_boundary(grid_ops.normalize_density(raw), pad)
