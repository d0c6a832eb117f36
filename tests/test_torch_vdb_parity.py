"""The port's OpenVDB reader (``data/vdb.py``) and blosc1 codec
(``data/blosc1.py``) against the JAX package's.

- Every case of ``tests/test_vdb.py`` and ``tests/test_blosc.py`` runs on
  the port's modules (but ``test_vdb_to_npz_tool``: the port ships no
  conversion tool; the ``.npz``-beside-the-archive rule is pinned below).
  The JAX package's test functions are called with their module globals
  (``vdb``, ``clouds``, ``blosc1``) pointed at the port's, so the
  spec-pinned LZ4 vectors, the hand-built OpenVDB-layout archive and the
  masked-value encodings hold the port's copy too.
- Across the packages: an archive written by one reads equal in the other
  (grid, bounding box, voxel size), for every compression, with and
  without half floats; a blosc frame compressed by one decompresses
  bitwise in the other; ``clouds.load_density`` of a ``.vdb`` in the port
  equals the JAX package's result, bitwise.

Every fixture is written here; none needs a download.
"""

import os

import numpy as np
import pytest

import test_blosc as jax_blosc_cases
import test_vdb as jax_vdb_cases
from deepestscatter_tpu.data import blosc1 as jblosc
from deepestscatter_tpu.data import clouds as jclouds
from deepestscatter_tpu.data import vdb as jvdb
from deepestscatter_tpu_torch.data import blosc1 as tblosc
from deepestscatter_tpu_torch.data import clouds as tclouds
from deepestscatter_tpu_torch.data import vdb as tvdb

VDB = {"jax": jvdb, "port": tvdb}
BLOSC = {"jax": jblosc, "port": tblosc}
PAIRS = [("jax", "port"), ("port", "jax"), ("port", "port")]


# -- the JAX package's cases, on the port's modules --------------------------

BLOSC_CASES = [
    ("test_lz4_literals_only", {}),
    ("test_lz4_simple_match", {}),
    ("test_lz4_overlap_run", {}),
    ("test_lz4_length_extension", {}),
    ("test_lz4_rejects_bad_offset", {}),
    ("test_lz4_compress_roundtrip", {}),
    *[("test_frame_roundtrip", {"codec": c, "split": sp, "shuffle": sh})
      for c in ("lz4", "zlib", "zstd") for sp in (True, False) for sh in (True, False)],
    ("test_frame_multiblock_and_leftover", {}),
    ("test_frame_memcpy_fallback", {}),
    ("test_frame_rejects_bitshuffle_and_unknown_codec", {}),
    ("test_shuffle_layout", {}),
    ("test_truncated_frames_raise_blosc_error", {}),
    ("test_truncated_lz4_block_raises_typed", {}),
]


def _ids(cases):
    return [name + "".join(f"-{v}" for v in kw.values()) for name, kw in cases]


@pytest.mark.parametrize("name,kwargs", BLOSC_CASES, ids=_ids(BLOSC_CASES))
def test_blosc_cases_hold_the_port(monkeypatch, name, kwargs):
    monkeypatch.setattr(jax_blosc_cases, "blosc1", tblosc)
    getattr(jax_blosc_cases, name)(**kwargs)


VDB_CASES = [
    *[("test_roundtrip_shapes", {"shape": s})
      for s in ((8, 8, 8), (17, 9, 23), (64, 64, 64), (130, 40, 70))],
    ("test_roundtrip_dense_values", {}),
    ("test_empty_grid", {}),
    ("test_bad_magic", {}),
    ("test_compressed_archive_equals_uncompressed_twin", {"compression": "zip"}),
    ("test_compressed_archive_equals_uncompressed_twin", {"compression": "blosc"}),
    ("test_clouds_load_density_vdb", {}),
    ("test_openvdb_style_fixture_archive", {}),
    ("test_masked_value_compression_read", {}),
    ("test_two_inactive_vals_selection_mask", {}),
    ("test_masked_blosc_compression_read", {}),
    *[("test_half_float_archive_equals_float_twin", {"compression": c})
      for c in ("none", "zip", "blosc")],
]


@pytest.mark.parametrize("name,kwargs", VDB_CASES, ids=_ids(VDB_CASES))
def test_vdb_cases_hold_the_port(monkeypatch, tmp_path, name, kwargs):
    monkeypatch.setattr(jax_vdb_cases, "vdb", tvdb)
    monkeypatch.setattr(jax_vdb_cases, "clouds", tclouds)
    fn = getattr(jax_vdb_cases, name)
    if "tmp_path" in fn.__code__.co_varnames[: fn.__code__.co_argcount]:
        kwargs = dict(kwargs, tmp_path=tmp_path)
    fn(**kwargs)


# -- across the packages ---------------------------------------------------------


def _sparse(shape, seed, density):
    rng = np.random.default_rng(seed)
    dense = rng.random(shape, dtype=np.float32)
    dense[rng.random(shape) > density] = 0.0
    return dense


@pytest.mark.parametrize("writer,reader", PAIRS)
@pytest.mark.parametrize("compression", ["none", "zip", "blosc"])
@pytest.mark.parametrize("half", [False, True])
def test_archive_written_by_one_package_reads_equal_in_the_other(tmp_path, writer, reader,
                                                                 compression, half):
    dense = _sparse((30, 17, 41), seed=13, density=0.3)
    path = str(tmp_path / "cloud.vdb")
    w = VDB[writer]
    w.write_vdb(path, w.VdbGrid("density", dense, voxel_size=1.25), compression=compression,
                save_float_as_half=half)
    got = VDB[reader].read_vdb(path)
    ref = VDB[writer].read_vdb(path)
    assert len(got) == len(ref) == 1
    g, r = got[0], ref[0]
    assert g.name == r.name == "density"
    assert g.bbox_min == r.bbox_min and g.voxel_size == r.voxel_size
    assert g.dense.dtype == r.dense.dtype == np.float32
    np.testing.assert_array_equal(g.dense, r.dense)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_grid_shapes_across_the_packages(tmp_path, writer, reader):
    dense = _sparse((130, 40, 70), seed=243, density=0.1)
    path = str(tmp_path / "big.vdb")
    VDB[writer].write_vdb(path, VDB[writer].VdbGrid("density", dense, voxel_size=2.5))
    a, b = VDB[reader].read_vdb(path)[0], jvdb.read_vdb(path)[0]
    np.testing.assert_array_equal(a.dense, b.dense)
    assert a.bbox_min == b.bbox_min


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("codec", ["lz4", "zlib", "zstd"])
@pytest.mark.parametrize("shuffle", [True, False])
def test_blosc_frames_cross_the_packages(direction, codec, shuffle):
    src, dst = ("jax", "port") if direction == "jax_to_port" else ("port", "jax")
    rng = np.random.default_rng(17)
    payload = np.cumsum(rng.normal(size=3000)).astype(np.float32).tobytes()
    for split in (True, False):
        frame = BLOSC[src].compress(payload, typesize=4, codec=codec, shuffle=shuffle,
                                    split=split)
        assert frame == BLOSC[dst].compress(payload, typesize=4, codec=codec, shuffle=shuffle,
                                            split=split)
        assert BLOSC[dst].decompress(frame) == payload


@pytest.mark.parametrize("compression", ["none", "zip", "blosc"])
def test_load_density_vdb_equals_the_jax_package(tmp_path, compression):
    dense = _sparse((24, 40, 17), seed=23, density=0.35)
    path = str(tmp_path / "cumulus.vdb")
    jvdb.write_vdb(path, jvdb.VdbGrid("density", dense, voxel_size=2.0),
                   compression=compression)
    got, ref = tclouds.load_density(path), jclouds.load_density(path)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_load_density_vdb_prefers_the_converted_npz(tmp_path):
    """As in the JAX package, a ``<path>.npz`` beside the archive wins."""
    path = str(tmp_path / "c.vdb")
    tvdb.write_vdb(path, tvdb.VdbGrid("density", _sparse((16, 16, 16), 3, 0.5)))
    converted = np.full((4, 5, 6), 0.5, np.float32)
    np.savez(path + ".npz", density=converted)
    np.testing.assert_array_equal(tclouds.load_density(path), converted)
    np.testing.assert_array_equal(jclouds.load_density(path), converted)
    os.remove(path + ".npz")
    np.testing.assert_array_equal(tclouds.load_density(path), jclouds.load_density(path))
