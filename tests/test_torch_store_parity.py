"""The port's record store against the JAX package's, on the CPU.

- A store written by the JAX package reads back byte-equal through the
  port's, and the reverse, for every record type (random bytes in every
  field), with ``read``, ``gather`` and ``count``.
- ``scenesetups.generate`` writes equal SceneSetup records in both
  packages (the same numpy RNG draws).
- The port builds its own copy of the C++ store into ``_build/`` (beside
  the kernels' builds); the JAX package's ``native/`` tree is byte-unchanged
  after the tests.
- The port's table semantics: CONTINUE-style counts, ``gather`` refusing
  ids past the count, ``drop`` asking for the table's name.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest

import deepestscatter_tpu
from deepestscatter_tpu.data import records as jrecords
from deepestscatter_tpu.data import scenesetups as jsetups
from deepestscatter_tpu.data.store import RecordStore as JaxStore
from deepestscatter_tpu_torch import cuda_build
from deepestscatter_tpu_torch.data import records as trecords
from deepestscatter_tpu_torch.data import scenesetups as tsetups
from deepestscatter_tpu_torch.data import store as tstore

NATIVE = Path(deepestscatter_tpu.__file__).resolve().parent / "native"


def _tree_digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module", autouse=True)
def native_unchanged():
    before = _tree_digest(NATIVE)
    yield
    assert _tree_digest(NATIVE) == before


def _random_records(name: str, n: int, seed: int) -> np.ndarray:
    dtype = trecords.SCHEMAS[name]
    raw = np.random.default_rng(seed).integers(0, 256, n * dtype.itemsize, dtype=np.uint8)
    return raw.view(dtype)


def test_schemas_equal_the_jax_packages():
    assert trecords.SCHEMAS.keys() == jrecords.SCHEMAS.keys()
    for name, dtype in trecords.SCHEMAS.items():
        assert dtype == jrecords.SCHEMAS[name], name
    assert (trecords.GRID_BYTES, trecords.BATCH_SIZE) == (2250, 2048)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_stores_read_each_other(tmp_path, writer):
    stores = {"jax": JaxStore, "port": tstore.RecordStore}
    w = stores[writer](str(tmp_path))
    written = {}
    for i, name in enumerate(trecords.SCHEMAS):
        recs = _random_records(name, 37, i)
        w.table(name).batch_append(0, recs[:20])
        w.table(name).batch_append(20, recs[20:])
        written[name] = recs
    w.close()
    r = stores["port" if writer == "jax" else "jax"](str(tmp_path))
    ids = np.array([36, 0, 17, 17, 5], dtype=np.uint64)
    for name, recs in written.items():
        assert r.count(name) == 37
        assert r.table(name).read(0, 100).tobytes() == recs.tobytes(), name
        assert r.table(name).gather(ids).tobytes() == recs[ids.astype(np.int64)].tobytes(), name
    r.close()


def test_scene_setups_equal(tmp_path):
    clouds = ["procedural:24:3", "procedural:24:4", "procedural:32:5", "a.npy"]
    t = tsetups.generate(str(tmp_path / "port"), clouds, seed=4, scenes_per_cloud=3)
    j = jsetups.generate(str(tmp_path / "jax"), clouds, seed=4, scenes_per_cloud=3)
    for split in ("train", "validation", "test"):
        a, b = t.all()[split], j.all()[split]
        assert a.count("SceneSetup") == b.count("SceneSetup")
        n = a.count("SceneSetup")
        assert a.table("SceneSetup").read(0, n).tobytes() == \
            b.table("SceneSetup").read(0, n).tobytes(), split
    rng_t, rng_j = np.random.default_rng(9), np.random.default_rng(9)
    assert tsetups.make_setups(clouds, rng_t, 2).tobytes() == \
        jsetups.make_setups(clouds, rng_j, 2).tobytes()


def test_store_builds_into_the_ports_build_dir():
    path = tstore.build()
    assert path.parent == cuda_build.BUILD_DIR and path.is_file()
    assert path == tstore.library_path()
    assert not str(path).startswith(str(NATIVE))


def test_table_semantics(tmp_path):
    s = tstore.RecordStore(str(tmp_path))
    t = s.table("Result")
    recs = _random_records("Result", 10, 3)
    t.batch_append(0, recs)
    assert s.count("Result") == 10 and len(t.read(8, 5)) == 2
    with pytest.raises(IndexError):
        t.gather(np.array([10], dtype=np.uint64))
    with pytest.raises(PermissionError):
        t.drop()
    t.drop(confirm="Result")
    assert s.count("Result") == 0
    with pytest.raises(KeyError):
        t.get_record(0)
    s.close()
