"""Record schemas: the durable data contract.

A copy of ``deepestscatter_tpu.data.records``, kept in this package so
that it imports nothing of the JAX package; the dtypes are byte for byte
the same, so a store written by either package reads back through the
other.  It mirrors the reference's 7 protobuf message types
(TR/Protocols/*.proto) as fixed-size numpy structured dtypes, so whole
batches map zero-copy between the native store and tensors.  Table name
= record type name on both sides, as in the reference (Dataset.h:76,
LmdbDataset.py:43-44).

Schema parity (field-for-field):
- SceneSetup            (cloud_path, cloud_size_m, light_direction)
- ScatterSample         (scene_setup_id, point, view_direction)
- Result                (light_intensity, is_converged)
- DisneyDescriptor      (grid: 10*9*5*5 bytes)
- BakedDescriptor       (grid, position, direction, power)
- BakedInterpolationSet (a, b, c, d: BakedDescriptor)
- Vector3               (x, y, z) — inlined as a 3-float subarray
"""

from __future__ import annotations

import numpy as np

GRID_BYTES = 10 * 9 * 5 * 5  # 2250 (DisneyDescriptor.h:8-33)
CLOUD_PATH_LEN = 256
BATCH_SIZE = 2048  # samples per scene (GlobalSettings.py:1)

VECTOR3 = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4")])

SCENE_SETUP = np.dtype(
    [
        ("cloud_path", f"S{CLOUD_PATH_LEN}"),
        ("cloud_size_m", "<f4"),
        ("light_direction", "<f4", (3,)),
    ]
)

SCATTER_SAMPLE = np.dtype(
    [
        ("scene_setup_id", "<i4"),
        ("point", "<f4", (3,)),
        ("view_direction", "<f4", (3,)),
    ]
)

RESULT = np.dtype([("light_intensity", "<f4"), ("is_converged", "u1")])

DISNEY_DESCRIPTOR = np.dtype([("grid", "u1", (GRID_BYTES,))])

BAKED_DESCRIPTOR = np.dtype(
    [
        ("grid", "u1", (GRID_BYTES,)),
        ("position", "<f4", (3,)),
        ("direction", "<f4", (3,)),
        ("power", "<f4"),
    ]
)

BAKED_INTERPOLATION_SET = np.dtype(
    [
        ("a", BAKED_DESCRIPTOR),
        ("b", BAKED_DESCRIPTOR),
        ("c", BAKED_DESCRIPTOR),
        ("d", BAKED_DESCRIPTOR),
    ]
)

#: Registry: table name → dtype (name = message name, as in the reference).
SCHEMAS = {
    "SceneSetup": SCENE_SETUP,
    "ScatterSample": SCATTER_SAMPLE,
    "Result": RESULT,
    "DisneyDescriptor": DISNEY_DESCRIPTOR,
    "BakedDescriptor": BAKED_DESCRIPTOR,
    "BakedInterpolationSet": BAKED_INTERPOLATION_SET,
}


def vector3(v) -> np.ndarray:
    return np.asarray([v[0], v[1], v[2]], np.float32)
