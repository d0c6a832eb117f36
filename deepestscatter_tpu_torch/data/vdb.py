"""Minimal OpenVDB (.vdb) reader/writer — the port's own copy of
``deepestscatter_tpu.data.vdb`` (numpy only; the port imports nothing of
the JAX package), unchanged in behaviour.  The native half of the
Resources::loadVolumeBuffer analog (reference: DG/src/Util/Resources.cpp:68-155
streams an OpenVDB FloatGrid into a dense max-normalized uint8 grid).

The reference links the full OpenVDB C++ library; this build needs only the
*file format* for the standard float 5-4-3 tree, so it implements that subset
directly (no OpenVDB dependency, which this image does not ship):

- archive header versions 220-224; NONE, ZIP, and BLOSC compression
  (blosc1 frames with byte shuffle + lz4/zlib/zstd — the subset OpenVDB
  emits when built WITH_BLOSC, its default; see ``data/blosc1.py``),
  active-mask value compression (all 7 per-node metadata modes),
  saveFloatAsHalf bulk buffers (``_HalfFloat`` grids, round 5);
- tree topology: RootNode tiles+children, Internal(5)/Internal(4) masks and
  tile values, Leaf(3) masks and voxel buffers;
- transforms: Affine/Scale/UniformScale/Translation/(Uniform)ScaleTranslate
  maps (voxel size recovered for CloudModel sizing);
- writer emits version-224 archives (NONE, ZIP, or BLOSC compression,
  metadata mode 6 — every value stored raw) used for round-trip tests.

Validation provenance (recorded honestly): every compressed fixture in the
test suite is written by this module's own writer or hand-built from the
public format specifications; the LZ4 block codec is additionally pinned
by hand-decoded external vectors.  An anchor fixture PRODUCED BY the
OpenVDB library itself is still missing — this build environment has no
OpenVDB (pyopenvdb absent, no C++ package) and no network egress, so no
library-written .vdb bytes can be obtained here; the committed parser
risk is a symmetric reader/writer misunderstanding of the container
framing.  First action on any machine with OpenVDB: write a tiny grid
with the library at each compression setting and check it into
tests/fixtures/.

Layout note: dense arrays here are [Z, Y, X] (the package-wide convention,
ops/grid.py) while VDB coordinates are (x, y, z).
"""

from __future__ import annotations

import struct
import uuid as uuid_mod
import zlib

from . import blosc1
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, List, Optional, Tuple

import numpy as np

MAGIC = 0x56444220  # int64 "VDB " tag of every OpenVDB archive
_FILE_VERSION = 224
_LIB_MAJOR, _LIB_MINOR = 8, 2

# Per-grid compression bit flags (openvdb/io/Compression.h).
COMPRESS_NONE = 0
COMPRESS_ZIP = 1
COMPRESS_ACTIVE_MASK = 2
COMPRESS_BLOSC = 4

# Per-node-buffer compression metadata (openvdb/io/Compression.h).
NO_MASK_OR_INACTIVE_VALS = 0  # inactive values are all background
NO_MASK_AND_MINUS_BG = 1  # inactive values are +background or -background
NO_MASK_AND_ONE_INACTIVE_VAL = 2  # one arbitrary inactive value
MASK_AND_NO_INACTIVE_VALS = 3  # selection mask, no inactive values stored
MASK_AND_ONE_INACTIVE_VAL = 4  # selection mask + one inactive value
MASK_AND_TWO_INACTIVE_VALS = 5  # selection mask + two inactive values
NO_MASK_AND_ALL_VALS = 6  # every value stored verbatim

# 5-4-3 tree geometry: Root -> Internal(2^5) -> Internal(2^4) -> Leaf(2^3).
_LOG2_UPPER, _LOG2_LOWER, _LOG2_LEAF = 5, 4, 3
_UPPER_DIM = 1 << _LOG2_UPPER  # 32
_LOWER_DIM = 1 << _LOG2_LOWER  # 16
_LEAF_DIM = 1 << _LOG2_LEAF  # 8
_UPPER_N = _UPPER_DIM**3  # 32768 slots
_LOWER_N = _LOWER_DIM**3  # 4096 slots
_LEAF_N = _LEAF_DIM**3  # 512 voxels
#: Voxel span of one upper-internal node (the root's child granularity).
UPPER_SPAN = _UPPER_DIM * _LOWER_DIM * _LEAF_DIM  # 4096
_LOWER_SPAN = _LOWER_DIM * _LEAF_DIM  # 128

_FLOAT_TREE = "Tree_float_5_4_3"
#: GridDescriptor::HALF_FLOAT_TYPENAME_SUFFIX — appended to the tree type
#: when the archive was written with ``saveFloatAsHalf``.
_HALF_SUFFIX = "_HalfFloat"


class VdbFormatError(ValueError):
    """Raised when an archive uses a feature outside the supported subset."""


# ---------------------------------------------------------------------------
# primitive stream helpers
# ---------------------------------------------------------------------------


def _read(f: BinaryIO, n: int) -> bytes:
    data = f.read(n)
    if len(data) != n:
        raise VdbFormatError(f"truncated archive (wanted {n} bytes, got {len(data)})")
    return data


def _read_struct(f: BinaryIO, fmt: str):
    vals = struct.unpack(fmt, _read(f, struct.calcsize(fmt)))
    return vals[0] if len(vals) == 1 else vals


def _read_string(f: BinaryIO) -> str:
    n = _read_struct(f, "<I")
    if n > 1 << 20:
        raise VdbFormatError(f"implausible string length {n}")
    return _read(f, n).decode("utf-8", errors="replace")


def _write_string(f: BinaryIO, s: str) -> None:
    raw = s.encode("utf-8")
    f.write(struct.pack("<I", len(raw)))
    f.write(raw)


def _load_mask(f: BinaryIO, n_bits: int) -> np.ndarray:
    """NodeMask::load — raw little-endian 64-bit words, LSB-first bits."""
    words = np.frombuffer(_read(f, n_bits // 8), dtype=np.uint8)
    return np.unpackbits(words, bitorder="little").astype(bool)


def _save_mask(f: BinaryIO, bits: np.ndarray) -> None:
    f.write(np.packbits(bits.astype(bool), bitorder="little").tobytes())


# ---------------------------------------------------------------------------
# per-node value buffers (io::readCompressedValues / writeCompressedValues)
# ---------------------------------------------------------------------------


def _read_raw_values(
    f: BinaryIO, count: int, compression: int, to_half: bool = False
) -> np.ndarray:
    """The value payload, honoring the zip/blosc framing (io::unzipFromStream
    and io::bloscFromStream share it: int64 byte count; a non-positive count
    means 'stored uncompressed').  Blosc takes precedence over zip when both
    flags are set, as in io::readData.

    ``to_half``: the archive was written with ``saveFloatAsHalf`` — the BULK
    value array is serialized as 2-byte IEEE half (io::HalfReader wraps only
    ``readData``; Compression.h) and converts to float on read.  Everything
    else (inactive-value metadata, background, root tiles) stays 4-byte
    float in such archives."""
    itemsize = 2 if to_half else 4
    dtype = "<f2" if to_half else "<f4"
    nbytes = count * itemsize
    blosced = bool(compression & COMPRESS_BLOSC)
    if not blosced and not (compression & COMPRESS_ZIP):
        return (
            np.frombuffer(_read(f, nbytes), dtype=dtype)
            .astype(np.float32, copy=True)
        )
    stored = _read_struct(f, "<q")
    if stored <= 0:
        return (
            np.frombuffer(_read(f, -stored if stored else nbytes), dtype=dtype)
            .astype(np.float32, copy=True)
        )
    payload = _read(f, stored)
    if blosced:
        raw = blosc1.decompress(payload)
        # OpenVDB pads sub-PAD_BYTES buffers before compressing
        # (io/Compression.cc bloscCompress) — tolerate a longer payload.
        if len(raw) < nbytes:
            raise VdbFormatError(
                f"blosc payload {len(raw)} < expected {nbytes}"
            )
        raw = raw[:nbytes]
    else:
        raw = zlib.decompress(payload)
        if len(raw) != nbytes:
            raise VdbFormatError(f"zip payload {len(raw)} != expected {nbytes}")
    return np.frombuffer(raw, dtype=dtype).astype(np.float32, copy=True)


def _read_compressed_values(
    f: BinaryIO,
    count: int,
    value_mask: np.ndarray,
    compression: int,
    background: float,
    file_version: int = _FILE_VERSION,
    to_half: bool = False,
) -> np.ndarray:
    """Reconstruct a node's ``count`` values from the stream."""
    # Since file version 222 the per-buffer metadata byte is ALWAYS present
    # (writeCompressedValues emits NO_MASK_AND_ALL_VALS when active-mask
    # compression is off); before that it never is.
    meta = _read_struct(f, "<b") if file_version >= 222 else (
        NO_MASK_AND_ALL_VALS
        if not (compression & COMPRESS_ACTIVE_MASK)
        else NO_MASK_OR_INACTIVE_VALS
    )
    if meta == NO_MASK_AND_ALL_VALS:
        return _read_raw_values(f, count, compression, to_half)

    inactive0 = np.float32(background)
    inactive1 = np.float32(-background)
    if meta in (NO_MASK_AND_ONE_INACTIVE_VAL, MASK_AND_ONE_INACTIVE_VAL):
        inactive0 = _read_struct(f, "<f")
    elif meta == MASK_AND_TWO_INACTIVE_VALS:
        inactive0 = _read_struct(f, "<f")
        inactive1 = _read_struct(f, "<f")
    elif meta == NO_MASK_AND_MINUS_BG:
        inactive0 = np.float32(-background)
        inactive1 = np.float32(background)

    sel_mask = None
    if meta in (
        MASK_AND_NO_INACTIVE_VALS,
        MASK_AND_ONE_INACTIVE_VAL,
        MASK_AND_TWO_INACTIVE_VALS,
    ):
        sel_mask = _load_mask(f, count)

    stored = _read_raw_values(f, int(value_mask.sum()), compression, to_half)
    out = np.full(count, np.float32(background), dtype=np.float32)
    if meta == NO_MASK_AND_MINUS_BG:
        out[:] = inactive0  # -background; NOTE: two-state case is rare
    elif meta != NO_MASK_OR_INACTIVE_VALS:
        out[:] = inactive0
    if sel_mask is not None:
        out[sel_mask] = inactive1
    out[value_mask] = stored
    return out


def _write_compressed_values(
    f: BinaryIO, values: np.ndarray, compression: int = COMPRESS_NONE,
    as_half: bool = False,
) -> None:
    """Writer path: metadata mode 6 (all values verbatim); NONE, ZIP, or
    BLOSC payload framing (the int64-count framing shared by
    io::zipToStream / io::bloscToStream: negative magnitude = stored raw).
    ``as_half`` serializes the bulk array as 2-byte half (saveFloatAsHalf;
    io::HalfWriter) — metadata values stay float."""
    f.write(struct.pack("<b", NO_MASK_AND_ALL_VALS))
    dtype = "<f2" if as_half else "<f4"
    raw = np.ascontiguousarray(values, dtype=dtype).tobytes()
    if compression & COMPRESS_BLOSC:
        comp = blosc1.compress(
            raw, typesize=2 if as_half else 4, codec="lz4", shuffle=True
        )
    elif compression & COMPRESS_ZIP:
        comp = zlib.compress(raw)
    else:
        f.write(raw)
        return
    if len(comp) < len(raw):
        f.write(struct.pack("<q", len(comp)))
        f.write(comp)
    else:
        f.write(struct.pack("<q", -len(raw)))
        f.write(raw)


# ---------------------------------------------------------------------------
# grid container
# ---------------------------------------------------------------------------


@dataclass
class VdbGrid:
    """One parsed (or to-be-written) float grid."""

    name: str
    #: Dense [Z, Y, X] voxel values covering ``bbox_min..bbox_min+shape-1``.
    dense: np.ndarray
    #: World-space index origin (x, y, z) of ``dense[0, 0, 0]``.
    bbox_min: Tuple[int, int, int] = (0, 0, 0)
    voxel_size: float = 1.0
    background: float = 0.0
    metadata: Dict[str, str] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


def _read_metamap(f: BinaryIO) -> Dict[str, str]:
    """MetaMap::readMeta — values kept as repr strings (opaque skip)."""
    out: Dict[str, str] = {}
    count = _read_struct(f, "<I")
    if count > 4096:
        raise VdbFormatError(f"implausible metadata count {count}")
    for _ in range(count):
        name = _read_string(f)
        type_name = _read_string(f)
        size = _read_struct(f, "<I")
        raw = _read(f, size)
        if type_name == "string":
            out[name] = raw.decode("utf-8", errors="replace")
        elif type_name == "float" and size == 4:
            out[name] = repr(struct.unpack("<f", raw)[0])
        elif type_name in ("int32", "int64", "bool"):
            out[name] = repr(int.from_bytes(raw, "little", signed=True))
        else:
            out[name] = f"<{type_name}:{size}B>"
    return out


#: Transform map payload sizes in Vec3d units (math/Maps.h write()).
_MAP_VEC3_COUNT = {
    "ScaleMap": 5,
    "UniformScaleMap": 5,
    "TranslationMap": 1,
    "ScaleTranslateMap": 6,
    "UniformScaleTranslateMap": 6,
    "UnitaryMap": 0,  # followed by an AffineMap payload
}


def _read_transform(f: BinaryIO) -> float:
    """Transform::read — returns the (uniform) voxel size."""
    map_type = _read_string(f)
    if map_type == "AffineMap" or map_type == "UnitaryMap":
        mat = np.frombuffer(_read(f, 16 * 8), dtype="<f8").reshape(4, 4)
        return float(np.linalg.norm(mat[0, :3]))
    if map_type == "NonlinearFrustumMap":
        raise VdbFormatError("NonlinearFrustumMap transforms are unsupported")
    if map_type not in _MAP_VEC3_COUNT:
        raise VdbFormatError(f"unknown transform map type {map_type!r}")
    vecs = np.frombuffer(
        _read(f, _MAP_VEC3_COUNT[map_type] * 24), dtype="<f8"
    ).reshape(-1, 3)
    if map_type == "TranslationMap":
        return 1.0
    # Scale-bearing maps store mScaleValues first.
    scale_idx = 1 if map_type in ("ScaleTranslateMap", "UniformScaleTranslateMap") else 0
    return float(vecs[scale_idx][0])


def _read_leaf_topology(f: BinaryIO) -> np.ndarray:
    return _load_mask(f, _LEAF_N)


@dataclass
class _Internal:
    origin: Tuple[int, int, int]
    child_mask: np.ndarray
    value_mask: np.ndarray
    values: np.ndarray
    children: Dict[int, "object"]  # slot -> _Internal | leaf value-mask


def _read_internal_topology(
    f: BinaryIO, origin, log2dim: int, compression: int, background: float,
    file_version: int = _FILE_VERSION, to_half: bool = False,
) -> _Internal:
    n = (1 << log2dim) ** 3
    child_mask = _load_mask(f, n)
    value_mask = _load_mask(f, n)
    values = _read_compressed_values(
        f, n, value_mask, compression, background, file_version, to_half
    )
    children: Dict[int, object] = {}
    span = _LOWER_SPAN if log2dim == _LOG2_UPPER else _LEAF_DIM
    dim = 1 << log2dim
    for slot in np.nonzero(child_mask)[0]:
        # Slot -> offset (x-major nesting: openvdb coordToOffset is
        # ((x & mask) << 2*log2) | ((y & mask) << log2) | (z & mask)).
        x = slot >> (2 * log2dim)
        y = (slot >> log2dim) & (dim - 1)
        z = slot & (dim - 1)
        corigin = (
            origin[0] + int(x) * span,
            origin[1] + int(y) * span,
            origin[2] + int(z) * span,
        )
        if log2dim == _LOG2_UPPER:
            children[int(slot)] = _read_internal_topology(
                f, corigin, _LOG2_LOWER, compression, background,
                file_version, to_half,
            )
        else:
            children[int(slot)] = (corigin, _read_leaf_topology(f))
    return _Internal(tuple(origin), child_mask, value_mask, values, children)


def _iter_leaves(node: _Internal):
    """Leaves in depth-first slot order — the buffer stream order."""
    for slot in np.nonzero(node.child_mask)[0]:
        child = node.children[int(slot)]
        if isinstance(child, _Internal):
            yield from _iter_leaves(child)
        else:
            yield child


def _read_grid_tree(
    f: BinaryIO, compression: int, file_version: int = _FILE_VERSION,
    to_half: bool = False,
) -> Tuple[float, List, List]:
    """Tree::readTopology + readBuffers for Tree_float_5_4_3.

    Returns (background, tiles, leaves): tiles = [(origin, span, value)],
    leaves = [(origin, value_mask, values[512])].
    """
    # Tree::readTopology header: Index32 buffer count (always 1 since 222).
    buffer_count = _read_struct(f, "<I")
    if buffer_count != 1:
        raise VdbFormatError(f"multi-buffer trees unsupported ({buffer_count})")
    background = _read_struct(f, "<f")
    num_tiles = _read_struct(f, "<I")
    num_children = _read_struct(f, "<I")
    tiles = []
    for _ in range(num_tiles):
        x, y, z = _read_struct(f, "<iii")
        value = _read_struct(f, "<f")
        active = _read_struct(f, "<b")
        if active:
            tiles.append(((x, y, z), UPPER_SPAN, value))
    roots: List[_Internal] = []
    for _ in range(num_children):
        origin = _read_struct(f, "<iii")
        roots.append(
            _read_internal_topology(
                f, origin, _LOG2_UPPER, compression, background,
                file_version, to_half,
            )
        )

    # Tile values inside internal nodes (active non-child slots).
    def collect_tiles(node: _Internal, log2dim: int):
        span = (_LOWER_SPAN if log2dim == _LOG2_UPPER else _LEAF_DIM)
        dim = 1 << log2dim
        active_tiles = node.value_mask & ~node.child_mask
        for slot in np.nonzero(active_tiles)[0]:
            x = slot >> (2 * log2dim)
            y = (slot >> log2dim) & (dim - 1)
            z = slot & (dim - 1)
            tiles.append(
                (
                    (
                        node.origin[0] + int(x) * span,
                        node.origin[1] + int(y) * span,
                        node.origin[2] + int(z) * span,
                    ),
                    span,
                    float(node.values[slot]),
                )
            )
        for child in node.children.values():
            if isinstance(child, _Internal):
                collect_tiles(child, _LOG2_LOWER)

    for r in roots:
        collect_tiles(r, _LOG2_UPPER)

    # Leaf buffers, in the same depth-first order as topology.  Each leaf
    # buffer record re-stores the 512-bit value mask (LeafNode::readBuffers
    # loads mValueMask again before io::readCompressedValues) — the mask is
    # in the file twice, once in topology and once here.
    leaves = []
    for r in roots:
        for origin, _topo_mask in _iter_leaves(r):
            value_mask = _load_mask(f, _LEAF_N)
            values = _read_compressed_values(
                f, _LEAF_N, value_mask, compression, background,
                file_version, to_half,
            )
            leaves.append((origin, value_mask, values))
    return background, tiles, leaves


def read_vdb(path: str, dense_limit: int = 2048) -> List[VdbGrid]:
    """Parse every float grid of ``path`` into dense [Z, Y, X] arrays.

    ``dense_limit`` caps any densified axis (a sparse kilometer-scale VDB
    could otherwise explode); the cloud grids this pipeline consumes are a
    few hundred voxels per side.
    """
    with open(path, "rb") as f:
        magic = _read_struct(f, "<q")
        if magic != MAGIC:
            raise VdbFormatError(f"not a VDB archive (magic {magic:#x})")
        file_version = _read_struct(f, "<I")
        if not 218 <= file_version <= 230:
            raise VdbFormatError(f"unsupported file version {file_version}")
        _read_struct(f, "<II")  # library major/minor
        has_offsets = bool(_read_struct(f, "<b"))
        archive_compression = COMPRESS_ZIP | COMPRESS_ACTIVE_MASK
        if 220 <= file_version < 222:
            archive_compression = (
                COMPRESS_ZIP if _read_struct(f, "<b") else COMPRESS_NONE
            )
        if file_version >= 218:
            _read(f, 36)  # 36-char ASCII uuid (since BOOST_UUID = 218)
        _read_metamap(f)  # archive metadata
        grid_count = _read_struct(f, "<I")

        grids: List[VdbGrid] = []
        for _ in range(grid_count):
            # GridDescriptor::read: unique name, grid type, instance-parent
            # name (always present since GRID_INSTANCING = 216, i.e. every
            # version this parser accepts), then the stream-position triple
            # which GridDescriptor::writeStreamPos emits UNCONDITIONALLY
            # (the header's offsets flag only says whether they are useful
            # for random access, not whether they exist).
            unique_name = _read_string(f)
            grid_type = _read_string(f)
            # saveFloatAsHalf archives append GridDescriptor's
            # HALF_FLOAT_TYPENAME_SUFFIX to the tree type; the in-memory
            # grid is float, only the serialized bulk buffers are half
            # (the reference reads these via the library like any other
            # grid, Resources.cpp:68-155).
            to_half = grid_type.endswith(_HALF_SUFFIX)
            if to_half:
                grid_type = grid_type[: -len(_HALF_SUFFIX)]
            instance_parent = _read_string(f)
            grid_pos, _block_pos, end_pos = _read_struct(f, "<qqq")
            if has_offsets and grid_pos > 0:
                f.seek(grid_pos)
            if instance_parent:
                # Instanced grids share the parent's tree and store no data
                # of their own beyond metadata+transform — skip.
                if end_pos <= 0:
                    raise VdbFormatError(
                        "cannot skip instanced grid without stream offsets"
                    )
                f.seek(end_pos)
                continue
            compression = archive_compression
            if file_version >= 222:
                compression = _read_struct(f, "<I")
            meta = _read_metamap(f)
            if grid_type != _FLOAT_TREE:
                if end_pos <= 0:
                    raise VdbFormatError(
                        f"cannot skip grid type {grid_type!r} without "
                        "stream offsets"
                    )
                f.seek(end_pos)
                continue
            voxel_size = _read_transform(f)
            background, tiles, leaves = _read_grid_tree(
                f, compression, file_version, to_half
            )
            grids.append(
                _densify(
                    unique_name.split("\x1e")[0],
                    background,
                    tiles,
                    leaves,
                    voxel_size,
                    meta,
                    dense_limit,
                )
            )
            if end_pos > 0:
                f.seek(end_pos)
        return grids


def _densify(
    name, background, tiles, leaves, voxel_size, meta, dense_limit
) -> VdbGrid:
    boxes = [(o, (o[0] + s - 1, o[1] + s - 1, o[2] + s - 1)) for o, s, _ in tiles]
    boxes += [
        (o, (o[0] + _LEAF_DIM - 1, o[1] + _LEAF_DIM - 1, o[2] + _LEAF_DIM - 1))
        for o, _, _ in leaves
    ]
    if not boxes:
        return VdbGrid(name, np.zeros((1, 1, 1), np.float32), (0, 0, 0), voxel_size, background, meta)
    mins = np.min([b[0] for b in boxes], axis=0)
    maxs = np.max([b[1] for b in boxes], axis=0)
    shape_xyz = maxs - mins + 1
    if np.any(shape_xyz > dense_limit):
        raise VdbFormatError(
            f"dense shape {tuple(shape_xyz)} exceeds limit {dense_limit}"
        )
    dense = np.full(tuple(shape_xyz[::-1]), np.float32(background))  # [Z,Y,X]
    for (ox, oy, oz), span, value in tiles:
        x, y, z = ox - mins[0], oy - mins[1], oz - mins[2]
        dense[z : z + span, y : y + span, x : x + span] = value
    for (ox, oy, oz), _mask, values in leaves:
        x, y, z = ox - mins[0], oy - mins[1], oz - mins[2]
        # Leaf storage is x-major: values[(x<<6)|(y<<3)|z] -> [X,Y,Z].
        block = values.reshape(_LEAF_DIM, _LEAF_DIM, _LEAF_DIM)
        dense[z : z + _LEAF_DIM, y : y + _LEAF_DIM, x : x + _LEAF_DIM] = (
            block.transpose(2, 1, 0)
        )
    return VdbGrid(name, dense, tuple(int(v) for v in mins), voxel_size, background, meta)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _write_metamap(f: BinaryIO, entries: Dict[str, str]) -> None:
    f.write(struct.pack("<I", len(entries)))
    for name, value in entries.items():
        _write_string(f, name)
        _write_string(f, "string")
        raw = value.encode("utf-8")
        f.write(struct.pack("<I", len(raw)))
        f.write(raw)


def _upper_children(dense: np.ndarray):
    """Root-level upper-node origins covering a dense [Z, Y, X] array
    anchored at index origin (0, 0, 0)."""
    nz, ny, nx = dense.shape
    ux = -(-nx // UPPER_SPAN)
    uy = -(-ny // UPPER_SPAN)
    uz = -(-nz // UPPER_SPAN)
    for cx in range(ux):
        for cy in range(uy):
            for cz in range(uz):
                yield (cx * UPPER_SPAN, cy * UPPER_SPAN, cz * UPPER_SPAN)


def _write_tree_topology(
    f: BinaryIO, dense: np.ndarray, background: float,
    compression: int = COMPRESS_NONE, as_half: bool = False,
) -> None:
    """Tree::writeTopology for a dense [Z, Y, X] array (masks + tile values;
    leaf voxel buffers are a separate stream section — ``_write_tree_buffers``)."""
    f.write(struct.pack("<I", 1))  # Tree topology buffer count
    f.write(struct.pack("<f", background))
    children = list(_upper_children(dense))
    f.write(struct.pack("<I", 0))  # no root tiles
    f.write(struct.pack("<I", len(children)))
    for origin in children:
        f.write(struct.pack("<iii", *origin))
        _write_internal(
            f, dense, origin, _LOG2_UPPER, background, compression, as_half
        )


def _write_tree_buffers(
    f: BinaryIO, dense: np.ndarray, compression: int = COMPRESS_NONE,
    as_half: bool = False,
) -> None:
    """Tree::writeBuffers — leaf voxel buffers in depth-first slot order."""
    for origin in _upper_children(dense):
        _write_leaf_buffers(f, dense, origin, _LOG2_UPPER, compression,
                            as_half)


def _node_slots(dense, origin, log2dim):
    """Yield (slot, child_origin, block) for occupied child slots."""
    nz, ny, nx = dense.shape
    dim = 1 << log2dim
    span = _LOWER_SPAN if log2dim == _LOG2_UPPER else _LEAF_DIM
    for x in range(dim):
        ox = origin[0] + x * span
        if ox >= nx:
            break
        for y in range(dim):
            oy = origin[1] + y * span
            if oy >= ny:
                break
            for z in range(dim):
                oz = origin[2] + z * span
                if oz >= nz:
                    break
                block = dense[oz : oz + span, oy : oy + span, ox : ox + span]
                if block.size and np.any(block != 0):
                    slot = (x << (2 * log2dim)) | (y << log2dim) | z
                    yield slot, (ox, oy, oz), block


def _write_internal(f, dense, origin, log2dim, background,
                    compression=COMPRESS_NONE, as_half=False):
    n = (1 << log2dim) ** 3
    child_mask = np.zeros(n, bool)
    slots = list(_node_slots(dense, origin, log2dim))
    for slot, _, _ in slots:
        child_mask[slot] = True
    _save_mask(f, child_mask)
    _save_mask(f, np.zeros(n, bool))  # no active tiles
    _write_compressed_values(
        f, np.full(n, background, np.float32), compression, as_half
    )
    for slot, corigin, _ in slots:
        if log2dim == _LOG2_UPPER:
            _write_internal(
                f, dense, corigin, _LOG2_LOWER, background, compression,
                as_half,
            )
        else:
            _write_leaf_topology(f, dense, corigin)


def _leaf_values(dense, origin) -> np.ndarray:
    nz, ny, nx = dense.shape
    ox, oy, oz = origin
    block = np.zeros((_LEAF_DIM, _LEAF_DIM, _LEAF_DIM), np.float32)  # [Z,Y,X]
    src = dense[oz : oz + _LEAF_DIM, oy : oy + _LEAF_DIM, ox : ox + _LEAF_DIM]
    block[: src.shape[0], : src.shape[1], : src.shape[2]] = src
    return np.ascontiguousarray(block.transpose(2, 1, 0)).reshape(-1)  # x-major


def _write_leaf_topology(f, dense, origin):
    _save_mask(f, _leaf_values(dense, origin) != 0)


def _write_leaf_buffers(f, dense, origin, log2dim,
                        compression=COMPRESS_NONE, as_half=False):
    for slot, corigin, _ in _node_slots(dense, origin, log2dim):
        if log2dim == _LOG2_UPPER:
            _write_leaf_buffers(f, dense, corigin, _LOG2_LOWER, compression,
                                as_half)
        else:
            # LeafNode::writeBuffers re-stores the value mask before the
            # compressed values (the mask is in the archive twice).
            values = _leaf_values(dense, corigin)
            _save_mask(f, values != 0)
            _write_compressed_values(f, values, compression, as_half)


def write_vdb(
    path: str,
    grid: VdbGrid,
    compression: str = "none",
    save_float_as_half: bool = False,
) -> None:
    """Write one float grid as a version-224 archive.

    ``compression``: "none", "zip", or "blosc" (blosc1 lz4+shuffle frames —
    the layout OpenVDB WITH_BLOSC emits; used to build genuine compressed
    fixtures for the reader tests).  ``save_float_as_half`` serializes bulk
    value buffers as 2-byte half with the ``_HalfFloat`` type suffix
    (GridDescriptor semantics) — real cloud assets are often written half
    to halve the file size.

    Mirrors ``io::Archive::writeGrid``: the descriptor reserves space for
    the (gridPos, blockPos, endPos) triple, the grid body is written, and
    the real positions are patched back in.
    """
    comp = {
        "none": COMPRESS_NONE,
        "zip": COMPRESS_ZIP,
        "blosc": COMPRESS_BLOSC,
    }[compression]
    if grid.bbox_min != (0, 0, 0):
        raise VdbFormatError("writer only supports origin-anchored grids")
    dense = np.asarray(grid.dense, np.float32)
    with open(path, "wb") as f:
        f.write(struct.pack("<q", MAGIC))
        f.write(struct.pack("<I", _FILE_VERSION))
        f.write(struct.pack("<II", _LIB_MAJOR, _LIB_MINOR))
        f.write(struct.pack("<b", 1))  # grid offsets are valid (seekable)
        f.write(str(uuid_mod.UUID(int=0)).encode("ascii"))  # deterministic
        _write_metamap(f, {})
        f.write(struct.pack("<I", 1))  # grid count
        # GridDescriptor::writeHeader: unique name, type, instance parent.
        _write_string(f, grid.name)
        _write_string(
            f, _FLOAT_TREE + (_HALF_SUFFIX if save_float_as_half else "")
        )
        _write_string(f, "")  # no instance parent
        stream_pos_at = f.tell()
        f.write(struct.pack("<qqq", 0, 0, 0))  # placeholder positions
        grid_pos = f.tell()
        f.write(struct.pack("<I", comp))
        _write_metamap(f, dict(grid.metadata))
        _write_string(f, "AffineMap")
        mat = np.eye(4, dtype="<f8") * 1.0
        mat[0, 0] = mat[1, 1] = mat[2, 2] = grid.voxel_size
        mat[3, 3] = 1.0
        f.write(mat.tobytes())
        _write_tree_topology(f, dense, grid.background, comp,
                             save_float_as_half)
        block_pos = f.tell()
        _write_tree_buffers(f, dense, comp, save_float_as_half)
        end_pos = f.tell()
        f.seek(stream_pos_at)
        f.write(struct.pack("<qqq", grid_pos, block_pos, end_pos))


def load_density_vdb(path: str, grid_name: Optional[str] = None) -> np.ndarray:
    """Dense [Z, Y, X] float density from a .vdb file — prefers a grid
    named ``density`` (the convention of published cloud assets)."""
    grids = read_vdb(path)
    if not grids:
        raise VdbFormatError(f"{path}: no float grids found")
    if grid_name is not None:
        for g in grids:
            if g.name == grid_name:
                return g.dense
        raise KeyError(f"{path}: no grid named {grid_name!r}")
    for g in grids:
        if g.name == "density":
            return g.dense
    return grids[0].dense
