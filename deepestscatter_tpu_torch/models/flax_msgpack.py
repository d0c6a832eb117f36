"""A reader of the JAX trainer's exports, without flax and without msgpack.

The JAX package writes its trained parameters as
``<Model>.params.msgpack`` through ``flax.serialization.to_bytes``: a
msgpack map of nested maps whose leaves are msgpack ext values.  Flax's
ext codes (``flax/serialization.py::_MsgpackExtType``):

- 1, an ndarray: the payload is itself msgpack, the array
  ``(shape, dtype name, C-order bytes)``;
- 3, a numpy scalar: the same payload with the shape ``()``.

This module decodes the msgpack subset such files use (nil, bool, the int
and float families, str, bin, array, map and ext in all their widths;
lengths and numbers big-endian) and those two ext codes.  It refuses
anything else loudly: another ext code, a ``bfloat16`` leaf (numpy has no
such dtype) and flax's chunked leaves (``__msgpack_chunked_array__``,
written only for arrays past 2**31 bytes).

``load_flax_msgpack(path)`` returns nested dicts of writable numpy arrays,
which ``models.convert``'s ``*_from_flax`` turn into state dicts.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Dict, Optional

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED_KEY = "__msgpack_chunked_array__"

#: Fixed-width scalars: tag → struct format (big-endian).
_SCALARS = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
#: Length-prefixed families: tag → (kind, struct format of the length).
_SIZED = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
}
#: fixext1..16: tag → payload length.
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}

ExtHook = Callable[[int, bytes], Any]


class _Decoder:
    def __init__(self, data: bytes, ext_hook: Optional[ExtHook]):
        self.data = memoryview(data)
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"msgpack data ends at byte {len(self.data)}, inside a value "
                             f"that needs {end}")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        tag = self.unpack(">B")
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return self.array(tag & 0x0F)
        if 0xA0 <= tag <= 0xBF:
            return self.str(tag & 0x1F)
        if tag == 0xC0:
            return None
        if tag in (0xC2, 0xC3):
            return tag == 0xC3
        if tag in _SCALARS:
            return self.unpack(_SCALARS[tag])
        if tag in _FIXEXT:
            return self.ext(_FIXEXT[tag])
        if tag in _SIZED:
            kind, fmt = _SIZED[tag]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            return getattr(self, kind)(n)
        raise ValueError(f"msgpack tag 0x{tag:02x} at byte {self.pos - 1} is not valid")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"msgpack map key {key!r} is neither str nor bytes")
            out[key] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if self.ext_hook is None:
            raise ValueError(f"msgpack ext type {code} where no ext type is expected")
        return self.ext_hook(code, payload)


def unpackb(data: bytes, ext_hook: Optional[ExtHook] = None) -> Any:
    """One msgpack value from ``data``, which it must fill exactly: arrays
    as lists, str as ``str``, bin as ``bytes``, maps as dicts with str or
    bytes keys (``msgpack.unpackb``'s defaults).  An ext value goes to
    ``ext_hook(code, payload)``; without a hook it raises."""
    dec = _Decoder(data, ext_hook)
    out = dec.value()
    if dec.pos != len(data):
        raise ValueError(f"{len(data) - dec.pos} bytes of msgpack data after the value")
    return out


def _ndarray(payload: bytes) -> np.ndarray:
    """Flax's ndarray payload → a writable array."""
    fields = unpackb(payload)
    if not (isinstance(fields, list) and len(fields) == 3):
        raise ValueError("a flax ndarray payload is not (shape, dtype, bytes)")
    shape, name, buffer = fields
    if isinstance(name, bytes):
        name = name.decode("ascii")
    if name == "bfloat16":
        raise ValueError("a bfloat16 leaf: numpy has no such dtype")
    dtype = np.dtype(name)
    if dtype.hasobject or not isinstance(buffer, bytes):
        raise ValueError(f"a flax ndarray of dtype {name} that this reader cannot hold")
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape, dtype=np.int64)) * dtype.itemsize != len(buffer):
        raise ValueError(f"a flax ndarray of shape {shape} and dtype {name} holds "
                         f"{len(buffer)} bytes")
    return np.frombuffer(buffer, dtype=dtype).reshape(shape).copy()


def flax_ext(code: int, payload: bytes) -> Any:
    """Flax's ext types: an ndarray (code 1) or a numpy scalar (code 3)."""
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        return _ndarray(payload)[()]
    raise ValueError(f"msgpack ext type {code} is not one flax writes for arrays "
                     f"({EXT_NDARRAY}: ndarray, {EXT_NPSCALAR}: numpy scalar)")


def _refuse_chunked(tree: Any, path: str) -> None:
    if isinstance(tree, dict):
        if CHUNKED_KEY in tree:
            raise ValueError(f"{path or 'the root'} is a chunked flax array (over 2**31 "
                             "bytes), which this reader does not join")
        for k, v in tree.items():
            _refuse_chunked(v, f"{path}/{k}")


def decode_flax(data: bytes) -> Dict[str, Any]:
    """``flax.serialization.to_bytes`` output → nested dicts of numpy
    arrays (``flax.serialization.msgpack_restore``'s result)."""
    tree = unpackb(data, flax_ext)
    if not isinstance(tree, dict):
        raise ValueError(f"a flax export holds a map at its root, not {type(tree).__name__}")
    _refuse_chunked(tree, "")
    return tree


def load_flax_msgpack(path: str) -> Dict[str, Any]:
    """Read a ``<Model>.params.msgpack`` export of the JAX trainer."""
    with open(path, "rb") as f:
        return decode_flax(f.read())
