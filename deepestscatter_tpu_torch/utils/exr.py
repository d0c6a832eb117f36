"""Minimal OpenEXR scanline IO (uncompressed, float32 RGB).

This package's own copy of ``deepestscatter_tpu.utils.exr`` (numpy only),
so the port imports nothing of the JAX package.

The reference saves progressive snapshots via the OpenEXR C++ library with
R/G/B FLOAT channels (reference: Camera.cpp:149-175).  We implement the EXR
container directly (no external dependency): version-2 scanline files, no
compression, INCREASING_Y.  Sufficient for snapshots, golden images and the
PT-vs-NN comparison tooling; readable by standard OpenEXR viewers.
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 0x01312F76
_FLOAT = 2  # OpenEXR pixel type


def _attr(name: bytes, type_: bytes, data: bytes) -> bytes:
    return name + b"\x00" + type_ + b"\x00" + struct.pack("<i", len(data)) + data


def _channel_list(names) -> bytes:
    out = b""
    for n in sorted(names):
        out += n.encode() + b"\x00"
        out += struct.pack("<i", _FLOAT)  # pixel type
        out += struct.pack("<BBBB", 0, 0, 0, 0)  # pLinear + reserved
        out += struct.pack("<ii", 1, 1)  # x/y sampling
    return out + b"\x00"


def write_exr(path: str, rgb: np.ndarray) -> None:
    """Write an [H, W, 3] float32 array as an uncompressed RGB EXR."""
    rgb = np.asarray(rgb, dtype=np.float32)
    assert rgb.ndim == 3 and rgb.shape[2] == 3, "expected [H, W, 3]"
    h, w, _ = rgb.shape
    channels = ["B", "G", "R"]  # EXR stores channels alphabetically

    header = b""
    header += _attr(b"channels", b"chlist", _channel_list(channels))
    header += _attr(b"compression", b"compression", struct.pack("<B", 0))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr(b"dataWindow", b"box2i", box)
    header += _attr(b"displayWindow", b"box2i", box)
    header += _attr(b"lineOrder", b"lineOrder", struct.pack("<B", 0))
    header += _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    header += _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\x00"

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        offset_table_pos = f.tell()
        scanline_size = 8 + 3 * w * 4  # y + size prefix + 3 channels
        first = offset_table_pos + 8 * h
        offsets = [first + i * scanline_size for i in range(h)]
        f.write(struct.pack(f"<{h}Q", *offsets))
        chan_data = {"R": rgb[..., 0], "G": rgb[..., 1], "B": rgb[..., 2]}
        for y in range(h):
            f.write(struct.pack("<ii", y, 3 * w * 4))
            for c in sorted(channels):
                f.write(chan_data[c][y].tobytes())


def read_exr(path: str) -> np.ndarray:
    """Read an uncompressed float32 scanline EXR back to [H, W, 3] (R, G, B).

    Supports the subset this module writes (plus arbitrary extra attributes);
    raises on compressed or tiled files.
    """
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != _MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    if version & 0x200:
        raise ValueError("tiled EXR not supported")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        name_end = data.index(b"\x00", pos)
        name = data[pos:name_end].decode()
        pos = name_end + 1
        type_end = data.index(b"\x00", pos)
        pos = type_end + 1
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        attrs[name] = data[pos : pos + size]
        pos += size
    pos += 1  # header terminator

    if struct.unpack_from("<B", attrs["compression"], 0)[0] != 0:
        raise ValueError("compressed EXR not supported")
    x0, y0, x1, y1 = struct.unpack_from("<iiii", attrs["dataWindow"], 0)
    w, h = x1 - x0 + 1, y1 - y0 + 1

    # Parse channel list (alphabetical order in file).
    chan_names = []
    cpos = 0
    chlist = attrs["channels"]
    while chlist[cpos] != 0:
        cend = chlist.index(b"\x00", cpos)
        chan_names.append(chlist[cpos:cend].decode())
        cpos = cend + 1 + 16
    line_order = struct.unpack_from("<B", attrs["lineOrder"], 0)[0]

    pos += 8 * h  # skip offset table
    img = {c: np.zeros((h, w), np.float32) for c in chan_names}
    for _ in range(h):
        y, size = struct.unpack_from("<ii", data, pos)
        pos += 8
        row = y - y0
        for c in chan_names:
            img[c][row] = np.frombuffer(data, np.float32, w, pos)
            pos += 4 * w
    del line_order  # each scanline block carries its own y; order-independent
    return np.stack(
        [img.get(c, np.zeros((h, w), np.float32)) for c in ("R", "G", "B")], axis=-1
    )
