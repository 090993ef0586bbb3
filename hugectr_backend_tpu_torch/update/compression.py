"""Kafka payload compression codecs (gzip / snappy / lz4 / zstd).

Port of the JAX package's update/compression.py; encoders and decoders give
the same bytes. Stock trainer-side producers (librdkafka/Java — reference
docs/hierarchical_parameter_server.md:575-646) commonly enable
``compression.type``. This module gives the update transport all four Kafka
codec ids:

- **gzip** — stdlib, both directions.
- **zstd** — the ``zstandard`` wheel, both directions (clear error naming
  the wheel if it is ever absent).
- **snappy** — decode is a full pure-Python implementation of the raw
  snappy block format, auto-detecting the snappy-java stream framing
  (``\\x82SNAPPY\\x00``) Java producers emit; encode emits literal-only raw
  snappy (valid for any decoder). The ``python-snappy`` wheel is used for
  both directions when importable.
- **lz4** — decode is a full pure-Python LZ4 *frame* parser + block
  decompressor (handles block-dependent frames by decoding into one
  contiguous window); encode emits frames of uncompressed blocks (valid
  LZ4F, with a correct xxhash32 header checksum, which librdkafka
  verifies). The ``lz4`` wheel is used when importable.

Without the wheels, snappy and lz4 blocks decode in the port's native
library. Kafka codec ids (attribute bits 0-2): 1=gzip 2=snappy 3=lz4
4=zstd.
"""

from __future__ import annotations

import gzip as _gzip
import struct
from typing import Optional

def _native():
    """The port's native library, which decodes raw snappy and lz4 blocks
    (kvstore.cpp ``hps_snappy_raw`` / ``hps_lz4_block``). A failed build
    raises. The pure-Python decoders below run only when a caller makes this
    return None: they are the plain versions the tests hold the native ones
    against."""
    from hugectr_backend_tpu_torch.native.kvstore import load_lib

    return load_lib()


CODEC_NONE, CODEC_GZIP, CODEC_SNAPPY, CODEC_LZ4, CODEC_ZSTD = 0, 1, 2, 3, 4

CODEC_IDS = {"none": 0, "gzip": 1, "snappy": 2, "lz4": 3, "zstd": 4}
CODEC_NAMES = {v: k for k, v in CODEC_IDS.items()}


def codec_id(codec: "int | str | None") -> int:
    if codec is None:
        return CODEC_NONE
    if isinstance(codec, int):
        if codec not in CODEC_NAMES:
            raise ValueError(f"unknown Kafka codec id {codec}")
        return codec
    try:
        return CODEC_IDS[codec.lower()]
    except KeyError:
        raise ValueError(
            f"unknown Kafka codec {codec!r} (want one of {sorted(CODEC_IDS)})"
        ) from None


# ------------------------------------------------------------------ xxhash32
# LZ4 frame headers carry an xxh32 checksum byte that real consumers
# (librdkafka) verify — needed for the encode path only, so a small
# pure-Python implementation suffices.

_XXP1, _XXP2, _XXP3, _XXP4, _XXP5 = (
    2654435761, 2246822519, 3266489917, 668265263, 374761393)
_M32 = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32(data: bytes, seed: int = 0) -> int:
    n = len(data)
    pos = 0
    if n >= 16:
        v1 = (seed + _XXP1 + _XXP2) & _M32
        v2 = (seed + _XXP2) & _M32
        v3 = seed
        v4 = (seed - _XXP1) & _M32
        while pos + 16 <= n:
            for i, v in enumerate((v1, v2, v3, v4)):
                (lane,) = struct.unpack_from("<I", data, pos + 4 * i)
                v = (v + lane * _XXP2) & _M32
                v = (_rotl32(v, 13) * _XXP1) & _M32
                if i == 0:
                    v1 = v
                elif i == 1:
                    v2 = v
                elif i == 2:
                    v3 = v
                else:
                    v4 = v
            pos += 16
        h = (_rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12)
             + _rotl32(v4, 18)) & _M32
    else:
        h = (seed + _XXP5) & _M32
    h = (h + n) & _M32
    while pos + 4 <= n:
        (lane,) = struct.unpack_from("<I", data, pos)
        h = (h + lane * _XXP3) & _M32
        h = (_rotl32(h, 17) * _XXP4) & _M32
        pos += 4
    while pos < n:
        h = (h + data[pos] * _XXP5) & _M32
        h = (_rotl32(h, 11) * _XXP1) & _M32
        pos += 1
    h ^= h >> 15
    h = (h * _XXP2) & _M32
    h ^= h >> 13
    h = (h * _XXP3) & _M32
    h ^= h >> 16
    return h


# ------------------------------------------------------------------- snappy

_SNAPPY_JAVA_MAGIC = b"\x82SNAPPY\x00"


def _snappy_varint(buf: bytes, pos: int) -> "tuple[int, int]":
    v = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7
        if shift > 35:
            raise ValueError("snappy: preamble varint too long")


def _snappy_decompress_raw(data: bytes) -> bytes:
    lib = _native()
    if lib is not None:
        import ctypes

        total, _ = _snappy_varint(data, 0)
        buf = bytearray(max(total, 1))
        n = lib.hps_snappy_raw(
            data, len(data),
            (ctypes.c_char * len(buf)).from_buffer(buf), total)
        if n < 0:
            raise ValueError("snappy: malformed block (native decoder)")
        return bytes(buf) if n == len(buf) else bytes(buf[:n])
    total, pos = _snappy_varint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                extra = ln - 59
                ln = int.from_bytes(data[pos:pos + extra], "little")
                pos += extra
            ln += 1
            out += data[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:  # copy, 1-byte offset
            ln = ((tag >> 2) & 0x7) + 4
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            ln = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            ln = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise ValueError("snappy: bad copy offset")
        start = len(out) - offset
        for i in range(ln):  # may overlap — byte-wise copy is the semantics
            out.append(out[start + i])
    if len(out) != total:
        raise ValueError(
            f"snappy: decoded {len(out)} bytes, preamble said {total}")
    return bytes(out)


def _snappy_decompress(data: bytes) -> bytes:
    try:
        import snappy  # type: ignore

        if data.startswith(_SNAPPY_JAVA_MAGIC):
            return _snappy_java_unframe(data, snappy.decompress)
        return snappy.decompress(data)
    except ImportError:
        pass
    if data.startswith(_SNAPPY_JAVA_MAGIC):
        return _snappy_java_unframe(data, _snappy_decompress_raw)
    return _snappy_decompress_raw(data)


def _snappy_java_unframe(data: bytes, block_fn) -> bytes:
    # snappy-java stream: magic(8) | version i32 | compat i32 |
    # repeated [block_len i32 | raw snappy block]
    pos = len(_SNAPPY_JAVA_MAGIC) + 8
    out = bytearray()
    while pos + 4 <= len(data):
        (ln,) = struct.unpack_from(">i", data, pos)
        pos += 4
        out += block_fn(data[pos:pos + ln])
        pos += ln
    return bytes(out)


def _snappy_compress(data: bytes) -> bytes:
    try:
        import snappy  # type: ignore

        return snappy.compress(data)
    except ImportError:
        pass
    # Literal-only raw snappy: valid for every decoder, no compression.
    out = bytearray()
    v = len(data)
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | 0x80 if v else b)
        if not v:
            break
    pos = 0
    while pos < len(data):
        chunk = data[pos:pos + (1 << 16)]
        ln = len(chunk) - 1
        if ln < 60:
            out.append(ln << 2)
        else:
            out.append(61 << 2)  # 2-byte literal length
            out += struct.pack("<H", ln)
        out += chunk
        pos += len(chunk)
    return bytes(out)


# --------------------------------------------------------------------- lz4

_LZ4_MAGIC = 0x184D2204


def _lz4_block_decompress(data: bytes, out: bytearray) -> None:
    """Decompress one LZ4 block APPENDING to ``out`` (the shared window —
    handles block-dependent frames where matches reach into prior blocks)."""
    pos = 0
    n = len(data)
    while pos < n:
        token = data[pos]
        pos += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = data[pos]
                pos += 1
                lit += b
                if b != 255:
                    break
        out += data[pos:pos + lit]
        pos += lit
        if pos >= n:  # final sequence: literals only
            break
        offset = int.from_bytes(data[pos:pos + 2], "little")
        pos += 2
        if offset == 0 or offset > len(out):
            raise ValueError("lz4: bad match offset")
        ml = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = data[pos]
                pos += 1
                ml += b
                if b != 255:
                    break
        start = len(out) - offset
        for i in range(ml):  # overlap-safe byte copy
            out.append(out[start + i])


def _lz4_frame_decompress(data: bytes) -> bytes:
    (magic,) = struct.unpack_from("<I", data, 0)
    if magic != _LZ4_MAGIC:
        raise ValueError(f"lz4: bad frame magic {magic:#x}")
    flg = data[4]
    if (flg >> 6) != 1:
        raise ValueError("lz4: unsupported frame version")
    pos = 6  # magic + FLG + BD
    if flg & 0x08:  # content size
        pos += 8
    if flg & 0x01:  # dict id
        pos += 4
    pos += 1  # header checksum (not verified on decode)
    block_checksum = bool(flg & 0x10)
    bd_max = (64 << 10) << (2 * max(((data[5] >> 4) & 0x7) - 4, 0))
    lib = _native()
    if lib is not None:
        import ctypes

        cap = max(4 * len(data), bd_max, 1 << 16)
        buf = bytearray(cap)
        end = 0
        while True:
            (bsz,) = struct.unpack_from("<I", data, pos)
            pos += 4
            if bsz == 0:
                break
            uncompressed = bool(bsz & 0x80000000)
            bsz &= 0x7FFFFFFF
            block = data[pos:pos + bsz]
            pos += bsz
            if block_checksum:
                pos += 4
            if end + bd_max > cap:  # grow the shared window
                cap = max(2 * cap, end + bd_max)
                nbuf = bytearray(cap)
                nbuf[:end] = buf[:end]
                buf = nbuf
            if uncompressed:
                buf[end : end + len(block)] = block
                end += len(block)
            else:
                end = lib.hps_lz4_block(
                    block, len(block),
                    (ctypes.c_char * cap).from_buffer(buf), cap, end)
                if end < 0:
                    raise ValueError("lz4: malformed block (native decoder)")
        return bytes(buf[:end])
    out = bytearray()
    while True:
        (bsz,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if bsz == 0:  # EndMark
            break
        uncompressed = bool(bsz & 0x80000000)
        bsz &= 0x7FFFFFFF
        block = data[pos:pos + bsz]
        pos += bsz
        if block_checksum:
            pos += 4
        if uncompressed:
            out += block
        else:
            _lz4_block_decompress(block, out)
    return bytes(out)


def _lz4_decompress(data: bytes) -> bytes:
    try:
        import lz4.frame  # type: ignore

        return lz4.frame.decompress(data)
    except ImportError:
        return _lz4_frame_decompress(data)


def _lz4_compress(data: bytes, legacy_kafka_hc: bool = False) -> bytes:
    if not legacy_kafka_hc:
        try:
            import lz4.frame  # type: ignore

            return lz4.frame.compress(data)
        except ImportError:
            pass
    # Frame of uncompressed blocks: valid LZ4F (librdkafka verifies the
    # header checksum, so compute the real xxh32 of FLG..BD).
    # ``legacy_kafka_hc``: pre-KIP-57 Kafka (message format v0/v1, the v0
    # wire dialect) computed the header checksum over the bytes INCLUDING
    # the 4-byte magic — and old brokers VALIDATE that broken convention
    # for magic-0 wrapper messages, so v0-dialect produce must emit it.
    flg = (1 << 6) | (1 << 5)  # version 01, block-independent
    bd = 7 << 4  # 4 MB max block size
    desc = bytes([flg, bd])
    hc_input = (struct.pack("<I", _LZ4_MAGIC) + desc
                if legacy_kafka_hc else desc)
    hc = (xxh32(hc_input) >> 8) & 0xFF
    out = bytearray(struct.pack("<I", _LZ4_MAGIC) + desc + bytes([hc]))
    pos = 0
    while pos < len(data):
        chunk = data[pos:pos + (4 << 20)]
        out += struct.pack("<I", len(chunk) | 0x80000000)
        out += chunk
        pos += len(chunk)
    out += struct.pack("<I", 0)  # EndMark
    return bytes(out)


# --------------------------------------------------------------------- zstd


def _zstd_module():
    try:
        import zstandard  # type: ignore

        return zstandard
    except ImportError:
        raise ImportError(
            "zstd-compressed Kafka payload needs the 'zstandard' wheel "
            "(pip install zstandard)"
        ) from None


# ---------------------------------------------------------------- dispatch


def compress(codec: "int | str | None", data: bytes,
             lz4_legacy_kafka_hc: bool = False) -> bytes:
    cid = codec_id(codec)
    if cid == CODEC_NONE:
        return data
    if cid == CODEC_GZIP:
        return _gzip.compress(data, compresslevel=1)
    if cid == CODEC_SNAPPY:
        return _snappy_compress(data)
    if cid == CODEC_LZ4:
        return _lz4_compress(data, legacy_kafka_hc=lz4_legacy_kafka_hc)
    return _zstd_module().ZstdCompressor(level=1).compress(data)


def decompress(codec: "int | str | None", data: bytes,
               expected_size: Optional[int] = None) -> bytes:
    cid = codec_id(codec)
    if cid == CODEC_NONE:
        return data
    if cid == CODEC_GZIP:
        return _gzip.decompress(data)
    if cid == CODEC_SNAPPY:
        return _snappy_decompress(data)
    if cid == CODEC_LZ4:
        return _lz4_decompress(data)
    z = _zstd_module()
    # decompressobj() handles frames WITHOUT an embedded content size —
    # what streaming producers (zstd-jni ZstdOutputStream) emit; the plain
    # one-shot decompress() would raise on those.
    return z.ZstdDecompressor().decompressobj().decompress(data)
