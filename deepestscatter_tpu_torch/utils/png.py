"""Minimal dependency-free PNG writer (RGB8) for snapshots.

This package's own copy of ``deepestscatter_tpu.utils.png`` (numpy, zlib
and struct only), so the port imports nothing of the JAX package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 array as a PNG file."""
    rgb = np.asarray(rgb)
    if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.dtype != np.uint8:
        raise ValueError(f"expected [H, W, 3] uint8, got {rgb.shape} {rgb.dtype}")
    h, w, _ = rgb.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        raw = tag + data
        return struct.pack(">I", len(data)) + raw + struct.pack(
            ">I", zlib.crc32(raw) & 0xFFFFFFFF
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    scanlines = b"".join(
        b"\x00" + rgb[y].tobytes() for y in range(h)
    )
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(scanlines, 6)))
        f.write(chunk(b"IEND", b""))
