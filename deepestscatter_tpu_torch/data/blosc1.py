"""Blosc1 frame codec — the subset OpenVDB emits (and its inverse).

The port's own copy of ``deepestscatter_tpu.data.blosc1`` (numpy only),
unchanged in behaviour.

OpenVDB built WITH_BLOSC (the default for distributed cloud assets)
compresses every node value buffer through ``blosc_compress_ctx`` with
byte shuffle and the LZ4 codec (openvdb/io/Compression.cc; the reference
reads such archives through the library, DG/src/Util/Resources.cpp:68-155).
This image ships no blosc/lz4 bindings, so the frame format is implemented
directly from the published c-blosc 1.x container layout and the LZ4 block
spec:

frame = 16-byte header
        | version | versionlz | flags | typesize | nbytes u32
        | blocksize u32 | cbytes u32 |
      + (memcpy frames) the raw payload, or
      + u32 bstarts[nblocks] (absolute offsets from frame start)
      + per block: one stream (dont-split) or ``typesize`` streams (split),
        each ``i32 cbytes`` + payload; ``cbytes == neblock`` marks a stream
        stored uncompressed.

flags: 0x1 byte-shuffle, 0x2 memcpy, 0x4 bit-shuffle (rejected), 0x10
dont-split (c-blosc >= 1.11 stores the split decision in the header — no
policy replication needed), bits 5-7 codec id (0 blosclz, 1 lz4, 2 snappy,
3 zlib, 4 zstd).  Shuffle applies per block, over the typesize-aligned
prefix.

Codecs: LZ4 block format (pure Python, spec-pinned by hand vectors in
tests/test_blosc.py, run on this copy by tests/test_torch_vdb_parity.py),
zlib (stdlib), zstd (``zstandard``, imported where a zstd stream is met).
The compressor half exists to build genuine blosc archives for round-trip
fixtures and for ``write_vdb(compression="blosc")``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

HEADER_SIZE = 16
MAX_OVERHEAD = HEADER_SIZE
_VERSION = 2
_VERSIONLZ = 1

FLAG_SHUFFLE = 0x1
FLAG_MEMCPY = 0x2
FLAG_BITSHUFFLE = 0x4
FLAG_DONT_SPLIT = 0x10

CODEC_BLOSCLZ = 0
CODEC_LZ4 = 1
CODEC_SNAPPY = 2
CODEC_ZLIB = 3
CODEC_ZSTD = 4

_CODEC_NAMES = {"blosclz": 0, "lz4": 1, "snappy": 2, "zlib": 3, "zstd": 4}

#: Streams smaller than this are stored raw (compression cannot win).
_MIN_COMPRESS = 16


class BloscError(ValueError):
    pass


# ---------------------------------------------------------------------------
# LZ4 block codec (pure Python; format per the public LZ4 block spec)
# ---------------------------------------------------------------------------


def lz4_decompress(src: bytes, dst_size: int) -> bytes:
    """Decode one LZ4 block: sequences of (token, literals, offset, match);
    the final sequence carries literals only.

    Corrupt/truncated input must fail with ``BloscError`` (the reader's
    error contract), never a raw ``IndexError`` from a byte read past the
    end — hence the explicit bounds checks on every length-extension and
    offset read."""
    dst = bytearray()
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if i >= n:
                    raise BloscError("lz4: truncated literal-length bytes")
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if lit:
            if i + lit > n:
                raise BloscError("lz4: literal run past end of block")
            dst += src[i:i + lit]
            i += lit
        if i >= n:
            break  # last sequence: literals only
        if i + 2 > n:
            raise BloscError("lz4: truncated match offset")
        off = src[i] | (src[i + 1] << 8)
        i += 2
        if off == 0:
            raise BloscError("lz4: zero match offset")
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                if i >= n:
                    raise BloscError("lz4: truncated match-length bytes")
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        start = len(dst) - off
        if start < 0:
            raise BloscError("lz4: match offset before block start")
        if off >= mlen:
            dst += dst[start:start + mlen]
        else:
            # Overlapping match = repeating pattern of period ``off``.
            pattern = bytes(dst[start:])
            reps = -(-mlen // off)
            dst += (pattern * reps)[:mlen]
    if len(dst) != dst_size:
        raise BloscError(f"lz4: decoded {len(dst)} bytes, expected {dst_size}")
    return bytes(dst)


def _lz4_emit(out: bytearray, data, lit_start, lit_end, off, mlen) -> None:
    lit = lit_end - lit_start
    ml = 0 if mlen == 0 else mlen - 4
    token = (min(lit, 15) << 4) | min(ml, 15)
    out.append(token)
    if lit >= 15:
        rest = lit - 15
        while rest >= 255:
            out.append(255)
            rest -= 255
        out.append(rest)
    out += data[lit_start:lit_end]
    if mlen:
        out += struct.pack("<H", off)
        if ml >= 15:
            rest = ml - 15
            while rest >= 255:
                out.append(255)
                rest -= 255
            out.append(rest)


def lz4_compress(data: bytes) -> bytes:
    """Greedy single-probe hash matcher — valid (not maximal) LZ4 blocks.

    Spec constraints honored: matches end >= 12 bytes before the block end
    and the last sequence is literal-only."""
    n = len(data)
    out = bytearray()
    if n == 0:
        out.append(0)  # empty final sequence
        return bytes(out)
    table: dict = {}
    anchor = 0
    i = 0
    limit = n - 12
    while i <= limit:
        key = data[i:i + 4]
        j = table.get(key, -1)
        table[key] = i
        if j >= 0 and i - j < 65536 and data[j:j + 4] == key:
            mlen = 4
            cap = n - 5 - i  # leave the spec's literal tail
            while mlen < cap and data[j + mlen] == data[i + mlen]:
                mlen += 1
            _lz4_emit(out, data, anchor, i, i - j, mlen)
            i += mlen
            anchor = i
        else:
            i += 1
    _lz4_emit(out, data, anchor, n, 0, 0)
    return bytes(out)


# ---------------------------------------------------------------------------
# shuffle filter (per block, over the typesize-aligned prefix)
# ---------------------------------------------------------------------------


def _shuffle(data: bytes, typesize: int) -> bytes:
    m = len(data) - (len(data) % typesize)
    if typesize <= 1 or m == 0:
        return data
    arr = np.frombuffer(data[:m], np.uint8).reshape(-1, typesize)
    return np.ascontiguousarray(arr.T).tobytes() + data[m:]


def _unshuffle(data: bytes, typesize: int) -> bytes:
    m = len(data) - (len(data) % typesize)
    if typesize <= 1 or m == 0:
        return data
    arr = np.frombuffer(data[:m], np.uint8).reshape(typesize, -1)
    return np.ascontiguousarray(arr.T).tobytes() + data[m:]


# ---------------------------------------------------------------------------
# stream codecs
# ---------------------------------------------------------------------------


def _codec_compress(codec: int, data: bytes, clevel: int) -> bytes:
    if codec == CODEC_LZ4:
        return lz4_compress(data)
    if codec == CODEC_ZLIB:
        return zlib.compress(data, min(clevel, 9))
    if codec == CODEC_ZSTD:
        import zstandard

        return zstandard.ZstdCompressor(level=min(clevel, 19)).compress(data)
    raise BloscError(f"unsupported blosc codec id {codec} for compression")


def _codec_decompress(codec: int, data: bytes, dst_size: int) -> bytes:
    if codec == CODEC_LZ4:
        return lz4_decompress(data, dst_size)
    if codec == CODEC_ZLIB:
        out = zlib.decompress(data)
    elif codec == CODEC_ZSTD:
        import zstandard

        out = zstandard.ZstdDecompressor().decompress(
            data, max_output_size=dst_size
        )
    else:
        name = {0: "blosclz", 2: "snappy"}.get(codec, str(codec))
        raise BloscError(f"unsupported blosc codec {name!r}")
    if len(out) != dst_size:
        raise BloscError(
            f"codec {codec}: decoded {len(out)} bytes, expected {dst_size}"
        )
    return out


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


def decompress(frame: bytes) -> bytes:
    """Decode one blosc1 frame to its raw payload."""
    if len(frame) < HEADER_SIZE:
        raise BloscError(f"frame shorter than header ({len(frame)} bytes)")
    version, _versionlz, flags, typesize = frame[0], frame[1], frame[2], frame[3]
    nbytes, blocksize, cbytes = struct.unpack_from("<III", frame, 4)
    if version < 1 or version > 3:
        raise BloscError(f"unsupported blosc frame version {version}")
    if cbytes > len(frame):
        raise BloscError(f"frame cbytes {cbytes} > available {len(frame)}")
    if flags & FLAG_BITSHUFFLE:
        raise BloscError("bit-shuffled blosc frames are unsupported")
    if flags & FLAG_MEMCPY:
        out = frame[HEADER_SIZE:HEADER_SIZE + nbytes]
        if len(out) != nbytes:
            raise BloscError("memcpy frame truncated")
        return bytes(out)
    if nbytes == 0:
        return b""
    codec = (flags >> 5) & 0x7
    shuffled = bool(flags & FLAG_SHUFFLE)
    dont_split = bool(flags & FLAG_DONT_SPLIT)
    if blocksize == 0:
        raise BloscError("zero blocksize in a non-memcpy frame")
    nblocks = -(-nbytes // blocksize)
    if HEADER_SIZE + 4 * nblocks > len(frame):
        raise BloscError(
            f"frame truncated: {nblocks} block starts do not fit in "
            f"{len(frame)} bytes"
        )
    bstarts = struct.unpack_from(f"<{nblocks}I", frame, HEADER_SIZE)
    out = bytearray()
    for bi in range(nblocks):
        bsize = min(blocksize, nbytes - bi * blocksize)
        leftover = bsize < blocksize
        split = (
            not dont_split
            and not leftover
            and typesize > 1
            and blocksize % typesize == 0
        )
        nstreams = typesize if split else 1
        neblock = bsize // nstreams
        pos = bstarts[bi]
        block = bytearray()
        for _ in range(nstreams):
            if pos + 4 > len(frame):
                raise BloscError(
                    f"block {bi}: stream header at {pos} past frame end"
                )
            (sbytes,) = struct.unpack_from("<i", frame, pos)
            pos += 4
            payload = frame[pos:pos + abs(sbytes)]
            if len(payload) != abs(sbytes):
                raise BloscError(
                    f"block {bi}: stream payload truncated "
                    f"({len(payload)} of {abs(sbytes)} bytes)"
                )
            pos += abs(sbytes)
            if sbytes == neblock:
                block += payload
            elif sbytes < 0:
                # c-blosc never emits negative stream sizes in v1 frames.
                raise BloscError(f"negative stream size {sbytes}")
            else:
                block += _codec_decompress(codec, payload, neblock)
        if shuffled:
            block = bytearray(_unshuffle(bytes(block), typesize))
        out += block
    if len(out) != nbytes:
        raise BloscError(f"frame decoded {len(out)} bytes, expected {nbytes}")
    return bytes(out)


def compress(
    data: bytes,
    typesize: int = 4,
    codec: str = "lz4",
    shuffle: bool = True,
    blocksize: int | None = None,
    split: bool = True,
    clevel: int = 9,
) -> bytes:
    """Encode one blosc1 frame (fixture/writer half; c-blosc compatible
    container).  Falls back to a memcpy frame when compression loses."""
    codec_id = _CODEC_NAMES[codec]
    nbytes = len(data)
    if typesize < 1:
        typesize = 1
    if blocksize is None:
        blocksize = min(max(nbytes, typesize), 1 << 17)
    blocksize = max(typesize, blocksize - blocksize % typesize)
    split = split and typesize > 1 and blocksize % typesize == 0
    flags = (codec_id << 5) | (0 if split else FLAG_DONT_SPLIT)
    if shuffle and typesize > 1:
        flags |= FLAG_SHUFFLE

    def header(fl: int, cb: int, bs: int) -> bytes:
        return struct.pack(
            "<BBBBIII",
            _VERSION, _VERSIONLZ, fl, min(typesize, 255),
            nbytes, bs, cb,
        )

    nblocks = -(-nbytes // blocksize) if nbytes else 0
    streams = bytearray()
    bstarts = []
    base = HEADER_SIZE + 4 * nblocks
    for bi in range(nblocks):
        bsize = min(blocksize, nbytes - bi * blocksize)
        block = data[bi * blocksize:bi * blocksize + bsize]
        if shuffle and typesize > 1:
            block = _shuffle(block, typesize)
        leftover = bsize < blocksize
        do_split = split and not leftover
        nstreams = typesize if do_split else 1
        neblock = bsize // nstreams
        bstarts.append(base + len(streams))
        for si in range(nstreams):
            chunk = block[si * neblock:(si + 1) * neblock]
            comp = (
                _codec_compress(codec_id, chunk, clevel)
                if neblock >= _MIN_COMPRESS
                else chunk
            )
            if len(comp) >= neblock:
                streams += struct.pack("<i", neblock) + chunk
            else:
                streams += struct.pack("<i", len(comp)) + comp
    total = base + len(streams)
    if total >= nbytes + HEADER_SIZE:
        return (
            header(flags | FLAG_MEMCPY, nbytes + HEADER_SIZE, blocksize) + data
        )
    return (
        header(flags, total, blocksize)
        + struct.pack(f"<{nblocks}I", *bstarts)
        + streams
    )
