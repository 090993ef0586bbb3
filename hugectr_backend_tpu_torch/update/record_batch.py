"""Kafka message-format v2 (RecordBatch) codec — KIP-98 framing.

Port of the JAX package's update/record_batch.py; the bytes are the same.

Kafka 4.0 removed the v0/v1 message formats and their request versions
(KIP-896), so interop with modern brokers requires producing and consuming
magic=2 RecordBatches: a fixed 61-byte batch header (CRC32C over
attributes..end — NOT zlib's CRC32) followed by varint-framed records with
zigzag-encoded lengths and deltas. This module implements the
non-transactional subset the update transport needs, including all four
compression codecs (gzip/snappy/lz4/zstd — update/compression.py, with
pure-Python snappy/lz4 fallbacks when the wheels are absent);
kafka_lite.py picks
this framing automatically when ApiVersions says the broker dropped v0
(update/kafka_lite.py ``KafkaClient.negotiate``).

Reference contract: the trainer-side producer in the reference pipeline is
stock librdkafka/Java (reference docs/hierarchical_parameter_server.md:
575-646), which emits exactly this format on any >=0.11 broker — so the
consumer half here reads real trainer output, and the producer half is
byte-compatible with what a real broker expects.

CRC32C rides the port's native library (native/kvstore.cpp ``hps_crc32c``,
hardware SSE4.2 or slice-by-8), so a 2 MB update message does not pay a
pure-Python per-byte loop; a failed build raises. ``_crc32c_py`` is the
plain version the tests hold it against.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

def _crc32c_py(data: bytes, seed: int = 0) -> int:
    """Table-driven CRC32C: the plain version the tests hold ``hps_crc32c``
    against (bit-identical)."""
    global _CRC_TABLE
    try:
        table = _CRC_TABLE
    except NameError:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    crc = ~seed & 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return ~crc & 0xFFFFFFFF


def crc32c(data: bytes, seed: int = 0) -> int:
    """CRC32C of ``data`` through the native library (``hps_crc32c``)."""
    from hugectr_backend_tpu_torch.native.kvstore import load_lib

    return load_lib().hps_crc32c(data, len(data), seed)


# ------------------------------------------------------------------ varints


def enc_varint(value: int) -> bytes:
    """Zigzag varint (Kafka record framing)."""
    z = (value << 1) ^ (value >> 63)
    out = bytearray()
    while True:
        b = z & 0x7F
        z >>= 7
        if z:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def dec_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    """-> (value, new_pos)."""
    z = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        z |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")
    return (z >> 1) ^ -(z & 1), pos


# ------------------------------------------------------------- RecordBatch

_HEADER = struct.Struct(">qiibIhiqqqhii")
# base_offset, batch_length, partition_leader_epoch, magic, crc, attributes,
# last_offset_delta, first_timestamp, max_timestamp, producer_id,
# producer_epoch, base_sequence, record_count
_ATTR_OFFSET = 8 + 4 + 4 + 1 + 4  # crc covers bytes from attributes on


def encode_record_batch(
    entries: List[Tuple[Optional[bytes], bytes]],
    base_offset: int = 0,
    timestamp_ms: int = 0,
    codec: "int | str | None" = 0,
) -> bytes:
    """One non-transactional RecordBatch, optionally compressed
    (``codec`` in none/gzip/snappy/lz4/zstd — attribute bits 0-2)."""
    from hugectr_backend_tpu_torch.update import compression

    cid = compression.codec_id(codec)
    records = bytearray()
    for i, (key, value) in enumerate(entries):
        body = bytearray(b"\x00")  # record attributes
        body += enc_varint(0)  # timestamp delta
        body += enc_varint(i)  # offset delta
        if key is None:
            body += enc_varint(-1)
        else:
            body += enc_varint(len(key))
            body += key
        body += enc_varint(len(value))
        body += value
        body += enc_varint(0)  # header count
        records += enc_varint(len(body))
        records += body
    if cid:
        records = bytearray(compression.compress(cid, bytes(records)))
    n = len(entries)
    header = _HEADER.pack(
        base_offset,
        0,  # batch_length placeholder
        -1,  # partition leader epoch
        2,  # magic
        0,  # crc placeholder
        cid,  # attributes bits 0-2: codec; create-time, non-transactional
        max(n - 1, 0),  # last offset delta
        timestamp_ms,
        timestamp_ms,
        -1,  # producer id
        -1,  # producer epoch
        -1,  # base sequence
        n,
    )
    batch = bytearray(header + bytes(records))
    # batch_length counts bytes after the length field itself.
    struct.pack_into(">i", batch, 8, len(batch) - 12)
    crc = crc32c(bytes(batch[_ATTR_OFFSET:]))
    struct.pack_into(">I", batch, 8 + 4 + 4 + 1, crc)
    return bytes(batch)


def decode_record_batches(
    raw: bytes, verify_crc: bool = False
) -> List[Tuple[int, Optional[bytes], bytes]]:
    """-> [(offset, key|None, value)] across all complete batches in ``raw``.

    Tolerates a truncated trailing batch (Fetch may cut the last one) and
    skips control batches (transaction markers from upstream producers).
    """
    out: List[Tuple[int, Optional[bytes], bytes]] = []
    pos = 0
    while pos + 12 <= len(raw):
        base_offset, batch_len = struct.unpack_from(">qi", raw, pos)
        end = pos + 12 + batch_len
        if batch_len <= 0 or end > len(raw):
            break
        magic = raw[pos + 16]
        if magic != 2:
            raise ValueError(
                f"RecordBatch magic {magic} (legacy MessageSet in a v2 "
                "stream — mixed-format topic?)"
            )
        (
            _bo,
            _bl,
            _ple,
            _magic,
            crc,
            attributes,
            _lod,
            _ts0,
            _ts1,
            _pid,
            _pep,
            _bsq,
            count,
        ) = _HEADER.unpack_from(raw, pos)
        if verify_crc and crc32c(raw[pos + _ATTR_OFFSET : end]) != crc:
            raise ValueError("RecordBatch CRC32C mismatch")
        if attributes & 0x20:  # control batch (txn markers): skip
            pos = end
            continue
        if attributes & 0x07:
            # Compressed batch: attribute bits 0-2 carry the codec id and
            # the records section (everything after the 61-byte header) is
            # one compressed blob (stock librdkafka/Java producers —
            # reference doc:575-646 — commonly enable compression.type).
            from hugectr_backend_tpu_torch.update import compression

            rec = compression.decompress(
                attributes & 0x07, raw[pos + _HEADER.size : end])
            rend_buf, rpos = rec, 0
            limit = len(rec)
        else:
            rend_buf, rpos = raw, pos + _HEADER.size
            limit = end
        for _ in range(count):
            if rpos >= limit:
                break
            rlen, rpos = dec_varint(rend_buf, rpos)
            rend = rpos + rlen
            p = rpos + 1  # skip record attributes
            _tsd, p = dec_varint(rend_buf, p)
            odelta, p = dec_varint(rend_buf, p)
            klen, p = dec_varint(rend_buf, p)
            key = None
            if klen >= 0:
                key = rend_buf[p : p + klen]
                p += klen
            vlen, p = dec_varint(rend_buf, p)
            value = rend_buf[p : p + vlen] if vlen >= 0 else b""
            out.append((base_offset + odelta, key, value))
            rpos = rend
        pos = end
    return out
