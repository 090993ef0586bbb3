"""The port's online update path against the JAX package's.

Each case of tests/test_update_source.py runs here on the port's modules
(hugectr_backend_tpu_torch.update, the port's parameter server on the CPU),
with the same inputs and the same expectations; the cases at the end hold the
two packages against each other directly: the same RecordBatch, MessageSet and
compressed bytes, the same CRC32C, a port producer feeding the JAX package's
broker and file queue and the other way round.
"""

import time

import numpy as np
import pytest

from hugectr_backend_tpu_torch.config.params import UpdateSourceParams, UpdateSourceType
from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
from hugectr_backend_tpu_torch.io.synthetic import expected_vector, make_synthetic_table
from hugectr_backend_tpu_torch.tiers.base import table_tag
from hugectr_backend_tpu_torch.update.source import (
    FileQueueSource,
    UpdateConsumer,
    make_update_source,
)


def _cpu_ps(cfg):
    from hugectr_backend_tpu_torch import HierParameterServer

    return HierParameterServer.create(cfg, device="cpu")


def test_file_queue_roundtrip(tmp_path):
    q = FileQueueSource(tmp_path / "q")
    keys = np.array([1, 5, 9], dtype=np.int64)
    vecs = np.arange(12, dtype=np.float32).reshape(3, 4)
    q.post("hps_et.m.t0", keys, vecs)
    q.post("hps_et.m.t0", keys + 100, vecs + 1)
    got = list(q.poll(0))
    assert len(got) == 2
    tag, k0, v0 = got[0]
    assert tag == "hps_et.m.t0"
    np.testing.assert_array_equal(k0, keys)
    np.testing.assert_array_equal(v0, vecs)
    # offsets advance: nothing new on re-poll
    assert list(q.poll(0)) == []
    # durability of offsets via commit + reopen
    q.commit()
    q2 = FileQueueSource(tmp_path / "q")
    assert list(q2.poll(0)) == []
    q2.post("hps_et.m.t0", keys, vecs)
    assert len(list(q2.poll(0))) == 1


def test_consumer_applies_with_chunking(tmp_path):
    q = FileQueueSource(tmp_path / "q")
    applied = []
    params = UpdateSourceParams(
        type=UpdateSourceType.FILE_QUEUE,
        poll_timeout_ms=10,
        max_batch_size=4,
        max_commit_interval=1,
    )
    consumer = UpdateConsumer(q, lambda t, k, v: applied.append((t, k.copy(), v.copy())), params)
    consumer.start()
    try:
        keys = np.arange(10, dtype=np.int64)
        vecs = np.tile(keys.astype(np.float32)[:, None], (1, 2))
        q.post("hps_et.m.t0", keys, vecs)
        deadline = time.time() + 10
        while consumer.applied_batches < 1 and time.time() < deadline:
            time.sleep(0.05)
        assert consumer.applied_batches == 1
        # chunked into ceil(10/4) = 3 applications
        assert len(applied) == 3
        all_keys = np.concatenate([k for _, k, _ in applied])
        np.testing.assert_array_equal(np.sort(all_keys), keys)
    finally:
        consumer.stop()


def test_kafka_source_constructs():
    """kafka_message_queue now builds the wire-protocol transport (round-2:
    no longer a NotImplementedError stub)."""
    from hugectr_backend_tpu_torch.update.kafka_lite import KafkaQueueSource

    params = UpdateSourceParams(
        type=UpdateSourceType.KAFKA_MESSAGE_QUEUE, brokers="127.0.0.1:19099"
    )
    src = make_update_source(params)
    assert isinstance(src, KafkaQueueSource)
    src.close()


def test_end_to_end_trainer_to_cache(tmp_path):
    """Producer posts updates; PS consumer lands them in DRAM; cache refresh
    makes them visible to lookups (the full reference update cycle)."""
    from hugectr_backend_tpu_torch import LookupSession

    tbl = make_synthetic_table(300, 8, seed=41)
    write_sparse_model(tmp_path / "t0", tbl.keys, tbl.vectors)
    qroot = str(tmp_path / "updates")
    ps = _cpu_ps(
        {
            "update_source": {
                "type": "file_queue",
                "brokers": qroot,
                "poll_timeout_ms": 20,
                "max_commit_interval": 1,
            },
            "models": [
                {
                    "model": "m",
                    "sparse_files": [str(tmp_path / "t0")],
                    "embedding_vecsize_per_table": [8],
                    "maxnum_catfeature_query_per_table_per_sample": [4],
                    "gpucacheper": 1.0,
                    "embedding_cache_type": "static",
                    "quant_bits": 32,
                }
            ],
        }
    )
    try:
        sess = LookupSession.create(ps.get_model_params("m"), ps.get_embedding_cache("m", 0))
        # Trainer side: publish new values for two keys.
        producer = FileQueueSource(qroot)
        new_vecs = np.full((2, 8), 9.0, np.float32)
        producer.post(table_tag("m", "sparse_embedding0"), tbl.keys[:2], new_vecs)
        # Wait for the consumer to land them in DRAM.
        deadline = time.time() + 10
        while time.time() < deadline:
            vecs, found = ps.dram.query(table_tag("m", "sparse_embedding0"), tbl.keys[:2])
            if found.all() and np.allclose(vecs, 9.0):
                break
            time.sleep(0.05)
        np.testing.assert_allclose(vecs, new_vecs)
        # Cache still serves the old value until refresh (async cycle).
        old = sess.lookup_numpy([tbl.keys[:1]])[0]
        np.testing.assert_allclose(old, expected_vector(tbl.keys[:1], 8), rtol=1e-6)
        ps.refresh_embedding_cache("m", 0)  # partial refresh per call
        ps.get_embedding_cache("m", 0).refresh(fraction=1.0)
        fresh = sess.lookup_numpy([tbl.keys[:2]])[0]
        np.testing.assert_allclose(fresh, new_vecs)
    finally:
        ps.shutdown()


# ------------------------------------------------------------ kafka_lite

def test_kafka_lite_roundtrip():
    """Producer -> mini broker -> Source roundtrip over the real TCP wire
    protocol (Produce/Fetch/ListOffsets/Metadata v0)."""
    from hugectr_backend_tpu_torch.update.kafka_lite import KafkaQueueSource
    from hugectr_backend_tpu_torch.update.mini_broker import MiniKafkaBroker

    broker = MiniKafkaBroker().start()
    try:
        src = KafkaQueueSource(f"127.0.0.1:{broker.port}")
        keys = np.arange(10, dtype=np.int64) * 7
        vecs = np.random.default_rng(0).standard_normal((10, 4)).astype(np.float32)
        assert src.post("hps_et.m.t0", keys, vecs) == 0
        assert src.post("hps_et.m.t0", keys + 100, vecs * 2) == 1
        src.post("hps_et.m.t1", keys[:3], vecs[:3, :2])

        got = list(src.poll(timeout_ms=10))
        tags = [t for t, _, _ in got]
        assert tags == ["hps_et.m.t0", "hps_et.m.t0", "hps_et.m.t1"]
        np.testing.assert_array_equal(got[0][1], keys)
        np.testing.assert_allclose(got[1][2], vecs * 2)
        np.testing.assert_allclose(got[2][2], vecs[:3, :2])
        # Offsets advanced: nothing new on the next poll.
        assert list(src.poll(timeout_ms=10)) == []
        # New message picked up.
        src.post("hps_et.m.t0", keys[:1], vecs[:1])
        again = list(src.poll(timeout_ms=10))
        assert len(again) == 1 and again[0][0] == "hps_et.m.t0"
        src.close()
    finally:
        broker.stop()


def test_kafka_multi_partition_roundtrip(tmp_path):
    """Multi-partition topics (reference doc:575-646 — trainer-side producers
    commonly spread a topic over several partitions): the consumer must fetch
    EVERY partition (round-2 silently read partition 0 only), offsets persist
    per partition, and our producer's murmur2 key partitioner matches stock
    Kafka's assignment."""
    import struct as _struct

    from hugectr_backend_tpu_torch.update.kafka_lite import (
        KafkaQueueSource,
        encode_update,
        murmur2,
        partition_for_key,
    )
    from hugectr_backend_tpu_torch.update.mini_broker import MiniKafkaBroker

    # Kafka's own murmur2 test vector (org.apache.kafka.common.utils
    # .UtilsTest): murmur2("21".getBytes) == -973932308 (signed int32).
    assert murmur2(b"21") == -973932308 & 0xFFFFFFFF

    broker = MiniKafkaBroker(num_partitions=3).start()
    try:
        offsets = tmp_path / "offsets.json"
        src = KafkaQueueSource(f"127.0.0.1:{broker.port}",
                               offsets_path=str(offsets))
        rng = np.random.default_rng(3)
        vecs = rng.standard_normal((4, 8)).astype(np.float32)

        # External-producer shape: one topic, messages spread over ALL
        # partitions (posted via the raw client, bypassing our partitioner).
        topic = "hps_et.m.t0"
        for pid in range(3):
            value = encode_update(8, np.arange(4, dtype=np.int64) + pid * 10,
                                  vecs + pid)
            src.client.produce(topic, pid, [(topic.encode(), value)])
        got = sorted(list(src.poll(timeout_ms=10)),
                     key=lambda tkv: tkv[1][0])
        assert len(got) == 3, "a partition's updates were dropped"
        for pid, (tag, k, v) in enumerate(got):
            assert tag == topic
            np.testing.assert_array_equal(k, np.arange(4) + pid * 10)
            np.testing.assert_allclose(v, vecs + pid)

        # Per-partition offsets survive commit + reopen.
        src.commit()
        src.close()
        src2 = KafkaQueueSource(f"127.0.0.1:{broker.port}",
                                offsets_path=str(offsets))
        assert list(src2.poll(timeout_ms=10)) == []

        # Our own post() lands on the murmur2-of-key partition.
        src2.post(topic, np.asarray([7], np.int64), vecs[:1])
        want_pid = partition_for_key(topic.encode(), 3)
        # Each partition held exactly one seed message; ours must have landed
        # on the murmur2-of-key partition.
        assert len(broker.logs[(topic, want_pid)]) == 2
        assert len(list(src2.poll(timeout_ms=10))) == 1
        src2.close()
    finally:
        broker.stop()


def test_kafka_record_batch_codec():
    """RecordBatch v2 codec: CRC32C known-answer vector, native/Python CRC
    parity, zigzag varint edges, and encode->decode round-trip incl. CRC
    verification and null keys."""
    from hugectr_backend_tpu_torch.update.record_batch import (
        _crc32c_py,
        crc32c,
        dec_varint,
        decode_record_batches,
        enc_varint,
        encode_record_batch,
    )

    # RFC 3720 §B.4 check value: crc32c("123456789") == 0xE3069283.
    assert crc32c(b"123456789") == 0xE3069283
    blob = bytes(range(256)) * 33 + b"tail"
    assert crc32c(blob) == _crc32c_py(blob)
    # Incremental == one-shot (seed chaining).
    assert crc32c(blob[777:], crc32c(blob[:777])) == crc32c(blob)

    for v in (0, 1, -1, 63, 64, -64, -65, 300, -300, 2**31, -(2**31), 2**62):
        got, pos = dec_varint(enc_varint(v), 0)
        assert got == v and pos == len(enc_varint(v))

    entries = [(b"k0", b"v0"), (None, b"null-key"), (b"k2", b"x" * 1000)]
    raw = encode_record_batch(entries, base_offset=42, timestamp_ms=123)
    got = decode_record_batches(raw, verify_crc=True)
    assert got == [(42, b"k0", b"v0"), (43, None, b"null-key"),
                   (44, b"k2", b"x" * 1000)]
    # Corrupt one payload byte -> CRC verification catches it.
    bad = bytearray(raw)
    bad[-1] ^= 0xFF
    with pytest.raises(ValueError, match="CRC32C"):
        decode_record_batches(bytes(bad), verify_crc=True)
    # Truncated trailing batch is tolerated (Fetch may cut the last one).
    two = raw + encode_record_batch([(b"k", b"v")], base_offset=45)
    assert decode_record_batches(two[:-3]) == got


def test_kafka_v2_dialect_roundtrip(tmp_path):
    """Against a Kafka >=4.0-style broker (v0 versions removed, KIP-896) the
    transport negotiates the v2 RecordBatch dialect and serves the same
    multi-partition contract as v0 (reference doc:575-646)."""
    from hugectr_backend_tpu_torch.update.kafka_lite import KafkaQueueSource
    from hugectr_backend_tpu_torch.update.mini_broker import MiniKafkaBroker

    broker = MiniKafkaBroker(num_partitions=3, dialect="v2").start()
    try:
        offsets = tmp_path / "offsets.json"
        src = KafkaQueueSource(f"127.0.0.1:{broker.port}",
                               offsets_path=str(offsets))
        keys = np.arange(6, dtype=np.int64)
        vecs = np.random.default_rng(1).standard_normal((6, 4)).astype(
            np.float32)
        src.post("hps_et.m.t0", keys, vecs)
        src.post("hps_et.m.t0", keys + 50, vecs * 3)
        assert src.client.mode == "v2"
        got = list(src.poll(timeout_ms=10))
        assert [t for t, _, _ in got] == ["hps_et.m.t0"] * 2
        np.testing.assert_array_equal(got[0][1], keys)
        np.testing.assert_allclose(got[1][2], vecs * 3)
        assert list(src.poll(timeout_ms=10)) == []
        # Offsets persist across reopen, same as the v0 dialect.
        src.commit()
        src.close()
        src2 = KafkaQueueSource(f"127.0.0.1:{broker.port}",
                                offsets_path=str(offsets))
        assert list(src2.poll(timeout_ms=10)) == []
        src2.post("hps_et.m.t0", keys[:2], vecs[:2])
        assert len(list(src2.poll(timeout_ms=10))) == 1
        src2.close()
    finally:
        broker.stop()


def test_kafka_neither_dialect_broker_fails_actionably():
    """A broker that speaks neither the v0 nor the v2 wire subset must be
    detected at connect time with an actionable error, not fail silently."""
    import struct as _struct

    from hugectr_backend_tpu_torch.update.kafka_lite import KafkaQueueSource
    from hugectr_backend_tpu_torch.update.mini_broker import MiniKafkaBroker

    class FutureBroker(MiniKafkaBroker):
        def _api_versions(self, r):
            # Hypothetical broker that dropped the non-flexible versions too.
            apis = [(0, 10, 12), (1, 14, 17), (2, 6, 8), (3, 10, 13),
                    (18, 0, 3)]
            out = _struct.pack(">hi", 0, len(apis))
            for api, lo, hi in apis:
                out += _struct.pack(">hhh", api, lo, hi)
            return out

    broker = FutureBroker().start()
    try:
        src = KafkaQueueSource(f"127.0.0.1:{broker.port}")
        with pytest.raises(IOError, match="neither"):
            list(src.poll(timeout_ms=10))
        src.close()
    finally:
        broker.stop()


@pytest.mark.parametrize("dialect", ["v0", "v2"])
def test_kafka_message_queue_serves_updates_end_to_end(tmp_path, dialect):
    """ps.json with update_source type=kafka_message_queue: streamed updates
    land in the DRAM/SSD tiers and reach lookups after a cache refresh
    (reference README.md:213-218 pipeline, served by the wire-protocol
    transport instead of raising) — against both broker generations
    (v0 MessageSet 0.8-3.x and v2 RecordBatch >=4.0/KIP-896)."""
    from hugectr_backend_tpu_torch import LookupSession
    from hugectr_backend_tpu_torch.update.kafka_lite import KafkaQueueSource
    from hugectr_backend_tpu_torch.update.mini_broker import MiniKafkaBroker

    broker = MiniKafkaBroker(dialect=dialect).start()
    try:
        tbl = make_synthetic_table(500, 8, seed=77)
        write_sparse_model(tmp_path / "t0", tbl.keys, tbl.vectors)
        ps = _cpu_ps(
            {
                "supportlonglong": True,
                "update_source": {
                    "type": "kafka_message_queue",
                    "brokers": f"127.0.0.1:{broker.port}",
                    "poll_timeout_ms": 50,
                    "max_commit_interval": 1,
                },
                "models": [
                    {
                        "model": "m",
                        "sparse_files": [str(tmp_path / "t0")],
                        "embedding_vecsize_per_table": [8],
                        "maxnum_catfeature_query_per_table_per_sample": [4],
                        "gpucacheper": 1.0,
                        "quant_bits": 32,
                    }
                ],
            }
        )
        sess = LookupSession.create(
            ps.get_model_params("m"), ps.get_embedding_cache("m", 0)
        )
        victim = tbl.keys[:4]
        new_rows = np.full((4, 8), 3.25, np.float32)

        producer = KafkaQueueSource(f"127.0.0.1:{broker.port}")
        producer.post(table_tag("m", "sparse_embedding0"), victim, new_rows)

        deadline = time.time() + 10
        tag = table_tag("m", "sparse_embedding0")
        while time.time() < deadline:
            vecs, found = ps.dram.query(tag, victim)
            if found.all() and np.allclose(vecs, new_rows):
                break
            time.sleep(0.05)
        else:
            raise AssertionError("kafka update never reached the DRAM tier")

        ps.get_embedding_cache("m", 0).refresh(fraction=1.0)
        out = sess.lookup_numpy([victim])[0]
        np.testing.assert_allclose(out, new_rows, atol=1e-6)
        producer.close()
    finally:
        ps.shutdown()
        broker.stop()


def test_compression_codecs_roundtrip():
    """All four Kafka codec ids round-trip; the pure-Python snappy/lz4
    fallback decoders handle back-reference (copy/match) streams built by
    hand; xxh32 (the LZ4 frame header checksum) matches known vectors."""
    import struct as _struct

    from hugectr_backend_tpu_torch.update import compression as C

    # xxhash32 known-answer vectors (seed 0).
    assert C.xxh32(b"") == 0x02CC5D05
    assert C.xxh32(b"a") == 0x550D7456
    assert C.xxh32(b"Nobody inspects the spammish repetition") == 0xE2293B2F

    data = (b"repetition " * 400 + bytes(range(256)) * 16
            + np.random.default_rng(0).bytes(4096))
    for name in ("gzip", "snappy", "lz4", "zstd"):
        packed = C.compress(name, data)
        assert C.decompress(name, packed) == data
        assert C.decompress(C.codec_id(name), packed) == data

    with pytest.raises(ValueError, match="unknown Kafka codec"):
        C.codec_id("brotli")

    # Snappy copy tag (1-byte offset): "abc" literal + copy(off=3, len=9).
    s = b"\x0c" + bytes([(3 - 1) << 2]) + b"abc" \
        + bytes([1 | ((9 - 4) << 2)]) + b"\x03"
    assert C._snappy_decompress_raw(s) == b"abcabcabcabc"
    # snappy-java stream framing (what Java producers emit).
    block = C._snappy_compress(b"hello world" * 64)
    framed = (C._SNAPPY_JAVA_MAGIC + (1).to_bytes(4, "big")
              + (1).to_bytes(4, "big")
              + _struct.pack(">i", len(block)) + block)
    assert C._snappy_decompress(framed) == b"hello world" * 64

    # LZ4 block with a match: literals "abcab" + match(off=5, len=18),
    # plus an extended match (len 15+240+4 via the 0xF escape).
    blk = bytes([(5 << 4) | (18 - 4)]) + b"abcab" + b"\x05\x00"
    out = bytearray()
    C._lz4_block_decompress(blk, out)
    assert bytes(out) == (b"abcab" * 5)[:23]
    blk2 = bytes([(5 << 4) | 0xF]) + b"abcab" + b"\x05\x00" + bytes([240])
    out2 = bytearray()
    C._lz4_block_decompress(blk2, out2)
    assert bytes(out2) == (b"abcab" * 53)[: 5 + 15 + 240 + 4]
    # Full frame around a compressed block (header checksum included).
    desc = bytes([(1 << 6) | (1 << 5), 4 << 4])
    frame = (_struct.pack("<I", C._LZ4_MAGIC) + desc
             + bytes([(C.xxh32(desc) >> 8) & 0xFF])
             + _struct.pack("<I", len(blk)) + blk + _struct.pack("<I", 0))
    assert C._lz4_frame_decompress(frame) == (b"abcab" * 5)[:23]


@pytest.mark.parametrize("codec", ["gzip", "snappy", "lz4", "zstd"])
def test_compressed_record_batch_roundtrip(codec):
    """v2 dialect: a compressed multi-record RecordBatch decodes (with CRC
    verification — the CRC covers the compressed bytes), closing round-3
    missing #3 (record_batch.py rejected any compressed batch)."""
    from hugectr_backend_tpu_torch.update.record_batch import (
        decode_record_batches,
        encode_record_batch,
    )

    entries = [(b"k0", b"v" * 500), (None, b"null-key"), (b"k2", b"z" * 99)]
    raw = encode_record_batch(entries, base_offset=7, codec=codec)
    got = decode_record_batches(raw, verify_crc=True)
    assert got == [(7, b"k0", b"v" * 500), (8, None, b"null-key"),
                   (9, b"k2", b"z" * 99)]
    # Mixed stream: compressed batch followed by an uncompressed one.
    mixed = raw + encode_record_batch([(b"k3", b"tail")], base_offset=10)
    assert decode_record_batches(mixed, verify_crc=True)[-1] == (
        10, b"k3", b"tail")


@pytest.mark.parametrize("codec", ["gzip", "snappy", "lz4", "zstd"])
def test_compressed_message_set_roundtrip(codec):
    """v0 dialect: a compressed wrapper message unwraps to its inner
    MessageSet with broker-convention offsets (wrapper offset = last
    inner offset)."""
    from hugectr_backend_tpu_torch.update.kafka_lite import (
        decode_message_set,
        encode_message_set,
    )
    import struct as _struct

    entries = [(b"a", b"v0"), (None, b"v1"), (b"c", b"v2" * 300)]
    ms = encode_message_set(entries, codec=codec)
    # Broker assigns the wrapper the LAST inner record's offset (here 44).
    ms = _struct.pack(">q", 44) + ms[8:]
    got = decode_message_set(ms)
    assert got == [(42, b"a", b"v0"), (43, None, b"v1"),
                   (44, b"c", b"v2" * 300)]


@pytest.mark.parametrize("dialect,codec", [
    ("v0", "gzip"), ("v0", "snappy"), ("v2", "lz4"), ("v2", "zstd"),
    ("v2", "gzip"), ("v0", "lz4"),
])
def test_kafka_compressed_fetch_end_to_end(tmp_path, dialect, codec):
    """Consumer reads a COMPRESSED multi-record batch in both dialects: the
    mini-broker's compressed-produce mode re-encodes fetch responses with
    the codec (simulating a trainer-side producer with compression.type
    set — reference doc:575-646), and the producer side also posts
    compressed."""
    from hugectr_backend_tpu_torch.update.kafka_lite import KafkaQueueSource
    from hugectr_backend_tpu_torch.update.mini_broker import MiniKafkaBroker

    broker = MiniKafkaBroker(dialect=dialect, fetch_codec=codec).start()
    try:
        src = KafkaQueueSource(f"127.0.0.1:{broker.port}",
                               offsets_path=str(tmp_path / "off.json"),
                               compression=codec)
        keys = np.arange(8, dtype=np.int64)
        vecs = np.random.default_rng(3).standard_normal((8, 4)).astype(
            np.float32)
        src.post("hps_et.m.t0", keys, vecs)
        src.post("hps_et.m.t0", keys + 100, vecs * 2)
        got = list(src.poll(timeout_ms=10))
        assert len(got) == 2
        np.testing.assert_array_equal(got[0][1], keys)
        np.testing.assert_allclose(got[0][2], vecs)
        np.testing.assert_array_equal(got[1][1], keys + 100)
        np.testing.assert_allclose(got[1][2], vecs * 2)
        # Offset bookkeeping survives compressed batches: nothing re-reads.
        assert list(src.poll(timeout_ms=10)) == []
        src.post("hps_et.m.t0", keys[:3], vecs[:3])
        assert len(list(src.poll(timeout_ms=10))) == 1
        src.close()
    finally:
        broker.stop()


def test_compression_native_matches_python(monkeypatch):
    """The native snappy/lz4 decoders (the port's kvstore.cpp) and the
    pure-Python plain versions decode identically, including match-heavy
    streams."""
    from hugectr_backend_tpu_torch.update import compression as C

    rng = np.random.default_rng(4)
    data = (b"abcab" * 5000 + rng.bytes(10_000) + b"Z" * 65_000
            + bytes(range(256)) * 64)
    for name in ("snappy", "lz4"):
        packed = C.compress(name, data)
        native = C.decompress(name, packed)
        with monkeypatch.context() as m:
            m.setattr(C, "_native", lambda: None)
            py = C.decompress(name, packed)
        assert native == py == data, name
    # Hand-built match-bearing streams through the NATIVE path.
    s = b"\x0c" + bytes([(3 - 1) << 2]) + b"abc" \
        + bytes([1 | ((9 - 4) << 2)]) + b"\x03"
    assert C._snappy_decompress_raw(s) == b"abcabcabcabc"
    import struct as _struct

    blk = bytes([(5 << 4) | (18 - 4)]) + b"abcab" + b"\x05\x00"
    desc = bytes([(1 << 6) | (1 << 5), 4 << 4])
    frame = (_struct.pack("<I", C._LZ4_MAGIC) + desc
             + bytes([(C.xxh32(desc) >> 8) & 0xFF])
             + _struct.pack("<I", len(blk)) + blk + _struct.pack("<I", 0))
    assert C._lz4_frame_decompress(frame) == (b"abcab" * 5)[:23]


@pytest.mark.parametrize("dialect", ["v0", "v2"])
def test_kafka_consumer_group_splits_partitions(tmp_path, dialect):
    """Two inference nodes in one consumer group split a multi-partition
    update topic without double-apply: JoinGroup/SyncGroup with the stock
    range assignor, broker-stored OffsetCommit/OffsetFetch, heartbeat-driven
    rebalance (the reference's librdkafka consumer behavior, doc:575-646;
    round-3 consumed node-locally only)."""
    from hugectr_backend_tpu_torch.update.kafka_lite import KafkaQueueSource
    from hugectr_backend_tpu_torch.update.mini_broker import MiniKafkaBroker

    broker = MiniKafkaBroker(num_partitions=4, dialect=dialect).start()
    broker.rebalance_window_s = 0.3
    try:
        # Producer (no group) spreads updates across partitions by key.
        prod = KafkaQueueSource(f"127.0.0.1:{broker.port}")
        rng = np.random.default_rng(5)
        sent = {}
        for i in range(12):
            tag = f"hps_et.m.t{i % 3}"
            keys = np.arange(4, dtype=np.int64) + 100 * i
            vecs = rng.standard_normal((4, 4)).astype(np.float32)
            prod.post(tag, keys, vecs)
            sent.setdefault(tag, []).append((keys, vecs))

        a = KafkaQueueSource(f"127.0.0.1:{broker.port}", group_id="hps-ps")
        b = KafkaQueueSource(f"127.0.0.1:{broker.port}", group_id="hps-ps")

        # Join concurrently (the broker's join barrier holds the first
        # joiner until the window closes).
        import threading
        got_a, got_b = [], []
        ta = threading.Thread(target=lambda: got_a.extend(a.poll(10)))
        tb = threading.Thread(target=lambda: got_b.extend(b.poll(10)))
        ta.start(); tb.start(); ta.join(10); tb.join(10)
        assert not ta.is_alive() and not tb.is_alive()

        # Disjoint partition assignments covering every partition.
        assert a._assignment is not None and b._assignment is not None
        for topic in sent:
            pa = set(a._assignment.get(topic, []))
            pb = set(b._assignment.get(topic, []))
            assert pa.isdisjoint(pb)
            assert pa | pb == set(range(4))
        # Between them, every update arrives exactly once.
        seen = {}
        for tag, keys, vecs in got_a + got_b:
            seen.setdefault(tag, []).append((keys, vecs))
        for tag, batches in sent.items():
            got_keys = np.sort(np.concatenate(
                [k for k, _ in seen.get(tag, [])]))
            want_keys = np.sort(np.concatenate([k for k, _ in batches]))
            np.testing.assert_array_equal(got_keys, want_keys)

        # Broker-stored offsets: a fresh member in the SAME group resumes
        # past everything already committed.
        a.commit(); b.commit()
        a.close(); b.close()
        c = KafkaQueueSource(f"127.0.0.1:{broker.port}", group_id="hps-ps")
        assert list(c.poll(10)) == []  # nothing new, nothing re-read
        prod.post("hps_et.m.t0", np.array([7], np.int64),
                  np.ones((1, 4), np.float32))
        fresh = list(c.poll(10))
        assert len(fresh) == 1 and fresh[0][0] == "hps_et.m.t0"
        c.close()
        prod.close()
    finally:
        broker.stop()


def test_lz4_v0_wrapper_uses_legacy_header_checksum():
    """Magic-0 lz4 wrapper messages must carry the pre-KIP-57 'broken'
    header checksum (xxh32 over magic+FLG+BD) that legacy brokers
    validate; standalone lz4 frames keep the spec checksum."""
    import struct as _struct

    from hugectr_backend_tpu_torch.update import compression as C
    from hugectr_backend_tpu_torch.update.kafka_lite import (
        decode_message_set,
        encode_message_set,
    )

    data = b"update-payload " * 100
    spec = C.compress("lz4", data)
    legacy = C.compress("lz4", data, lz4_legacy_kafka_hc=True)
    desc = spec[4:6]
    assert spec[6] == (C.xxh32(desc) >> 8) & 0xFF
    assert legacy[6] == (C.xxh32(legacy[:6]) >> 8) & 0xFF
    assert spec[6] != legacy[6]  # genuinely different conventions here
    assert C.decompress("lz4", legacy) == data  # we read either

    ms = encode_message_set([(b"k", data)], codec="lz4")
    # wrapper value starts after offset(8)+size(4)+crc(4)+magic/attrs(2)+
    # null key(4) + value len(4)
    frame = ms[8 + 4 + 4 + 2 + 4 + 4:]
    (magic,) = _struct.unpack_from("<I", frame, 0)
    assert magic == C._LZ4_MAGIC
    assert frame[6] == (C.xxh32(frame[:6]) >> 8) & 0xFF  # legacy HC
    got = decode_message_set(_struct.pack(">q", 0) + ms[8:])
    assert got == [(0, b"k", data)]


def test_offset_commit_generation_fencing():
    """A stale member's late commit (pre-rebalance generation) is rejected
    by the coordinator (OffsetCommit v1 fencing) instead of rewinding the
    new partition owner's offsets."""
    from hugectr_backend_tpu_torch.update.kafka_lite import (
        KafkaGroupError,
        KafkaQueueSource,
    )
    from hugectr_backend_tpu_torch.update.mini_broker import MiniKafkaBroker

    broker = MiniKafkaBroker(num_partitions=2).start()
    broker.rebalance_window_s = 0.2
    try:
        prod = KafkaQueueSource(f"127.0.0.1:{broker.port}")
        keys = np.arange(4, dtype=np.int64)
        vecs = np.ones((4, 4), np.float32)
        prod.post("hps_et.m.t0", keys, vecs)

        a = KafkaQueueSource(f"127.0.0.1:{broker.port}", group_id="g")
        assert len(list(a.poll(10))) == 1
        a.commit()
        committed = dict(broker.group_offsets)
        assert committed, "commit must store offsets"
        # Fake a stale generation (as after a rebalance a missed): direct
        # client-level commit with the OLD generation must be fenced.
        with broker._gcv:
            broker.groups["g"]["generation"] += 1
        with pytest.raises(KafkaGroupError, match="error 22"):
            a.client.offset_commit(
                "g", {("hps_et.m.t0", 0): 0},
                generation=a._generation, member_id=a._member_id)
        assert broker.group_offsets == committed  # unchanged
        a.close()
        prod.close()
    finally:
        broker.stop()


def test_file_queue_quarantines_corrupt_file(tmp_path):
    """A corrupt update file is quarantined (renamed .bad, offset advanced)
    instead of stalling every table's updates forever."""
    q = FileQueueSource(tmp_path / "q")
    keys = np.arange(3, dtype=np.int64)
    vecs = np.ones((3, 4), np.float32)
    q.post("hps_et.m.t0", keys, vecs)
    q.post("hps_et.m.t0", keys + 10, vecs * 2)
    # Corrupt the FIRST file (truncate mid-payload).
    d = tmp_path / "q" / "hps_et.m.t0"
    first = sorted(d.glob("*.upd"))[0]
    first.write_bytes(first.read_bytes()[:9])
    got = list(q.poll(0))
    # The good batch still flows; the poison one is quarantined.
    assert len(got) == 1
    np.testing.assert_array_equal(got[0][1], keys + 10)
    assert list(d.glob("*.bad")), "corrupt file must be quarantined"
    # Next poll: nothing re-read, no stall.
    assert list(q.poll(0)) == []
    q.post("hps_et.m.t0", keys + 50, vecs)
    assert len(list(q.poll(0))) == 1


def test_file_queue_multiprocess_sequencing(tmp_path):
    """Two producer handles (simulating separate processes — the in-process
    lock does not serialize them) must never overwrite each other's
    sequence numbers: the hard-link claim makes the loser take the next
    number."""
    q1 = FileQueueSource(tmp_path / "q")
    q2 = FileQueueSource(tmp_path / "q")
    keys = np.arange(2, dtype=np.int64)
    vecs = np.ones((2, 4), np.float32)
    seqs = [q1.post("hps_et.m.t0", keys, vecs),
            q2.post("hps_et.m.t0", keys + 10, vecs * 2),
            q1.post("hps_et.m.t0", keys + 20, vecs * 3)]
    assert len(set(seqs)) == 3
    got = list(FileQueueSource(tmp_path / "q").poll(0))
    assert len(got) == 3  # nothing overwritten


def test_kafka_forced_rebalance_mid_stream():
    """A rebalance the consumer MISSED (generation bumped while it was
    between polls) must fence its next heartbeat; the consumer rejoins,
    resumes from its committed offsets, and the update stream neither
    loses a batch nor re-reads committed ones. The reference inherits this
    from librdkafka (doc:575-646); a from-scratch client needs the proof."""
    from hugectr_backend_tpu_torch.update.kafka_lite import KafkaQueueSource
    from hugectr_backend_tpu_torch.update.mini_broker import MiniKafkaBroker

    broker = MiniKafkaBroker(num_partitions=4).start()
    broker.rebalance_window_s = 0.2
    try:
        prod = KafkaQueueSource(f"127.0.0.1:{broker.port}")
        rng = np.random.default_rng(11)
        for i in range(6):
            prod.post(f"hps_et.m.t{i % 2}",
                      np.arange(3, dtype=np.int64) + 10 * i,
                      rng.standard_normal((3, 4)).astype(np.float32))

        a = KafkaQueueSource(f"127.0.0.1:{broker.port}", group_id="g")
        first = list(a.poll(10))
        assert len(first) == 6
        a.commit()
        gen0 = a._generation

        # Simulate a rebalance this member missed: the coordinator moved
        # the group to a new generation (another member joined and left).
        with broker._gcv:
            broker.groups["g"]["generation"] += 1
            broker.groups["g"]["assignments"] = {}

        # New updates land after the missed rebalance.
        sent_after = []
        for i in range(4):
            keys = np.arange(2, dtype=np.int64) + 1000 + 10 * i
            prod.post("hps_et.m.t0", keys,
                      rng.standard_normal((2, 4)).astype(np.float32))
            sent_after.append(keys)

        # Next poll: stale-generation heartbeat -> fence -> rejoin -> fetch
        # resumes from the COMMITTED offsets (no loss, no re-read).
        second = list(a.poll(10))
        assert a._generation > gen0
        got = np.sort(np.concatenate([k for _t, k, _v in second]))
        np.testing.assert_array_equal(got, np.sort(np.concatenate(sent_after)))
        a.commit()  # post-rejoin commit passes the generation fence
        assert list(a.poll(5)) == []
        a.close()
        prod.close()
    finally:
        broker.stop()


def test_kafka_coordinator_failover():
    """Coordinator dies mid-stream and comes back (same address) with the
    replicated log + committed offsets but NO member sessions — the real
    failover shape. The consumer must survive the dead socket, rejoin with
    a fresh member id, resume from committed offsets, and apply every
    update exactly once to the cache (idempotence asserted at the end
    state)."""
    from hugectr_backend_tpu_torch.update.kafka_lite import KafkaQueueSource
    from hugectr_backend_tpu_torch.update.mini_broker import MiniKafkaBroker

    broker = MiniKafkaBroker(num_partitions=2).start()
    broker.rebalance_window_s = 0.2
    port = broker.port
    applied: dict = {}  # key -> vector, the "cache" (idempotent target)

    def apply(batches):
        n = 0
        for _tag, keys, vecs in batches:
            for k, v in zip(keys, vecs):
                applied[int(k)] = v
            n += 1
        return n

    try:
        prod = KafkaQueueSource(f"127.0.0.1:{port}")
        rng = np.random.default_rng(12)
        want: dict = {}
        for i in range(5):
            keys = np.arange(3, dtype=np.int64) + 100 * i
            vecs = rng.standard_normal((3, 4)).astype(np.float32)
            prod.post("hps_et.m.t0", keys, vecs)
            for k, v in zip(keys, vecs):
                want[int(k)] = v

        c = KafkaQueueSource(f"127.0.0.1:{port}", group_id="g")
        assert apply(c.poll(10)) == 5
        c.commit()
        member0 = c._member_id

        # Kill the coordinator; bring up its replacement on the SAME
        # address carrying the replicated log + committed offsets, but no
        # live member sessions.
        logs, offsets = broker.logs, broker.group_offsets
        broker.stop()
        prod.close()
        # Sever the consumer's dead sockets so the server-side halves leave
        # FIN_WAIT (they'd otherwise block the failover broker's bind);
        # the client transparently reconnects on its next request.
        c.client.close()
        broker2 = None
        for _ in range(100):  # the dead broker's conn sockets linger briefly
            try:
                broker2 = MiniKafkaBroker(port=port, num_partitions=2)
                break
            except OSError:
                time.sleep(0.1)
        assert broker2 is not None, "could not rebind the coordinator port"
        broker2.start()
        broker2.rebalance_window_s = 0.2
        broker2.logs = logs
        broker2.group_offsets = offsets
        try:
            prod2 = KafkaQueueSource(f"127.0.0.1:{port}")
            sent_after = []
            for i in range(3):
                keys = np.arange(2, dtype=np.int64) + 5000 + 10 * i
                vecs = rng.standard_normal((2, 4)).astype(np.float32)
                prod2.post("hps_et.m.t0", keys, vecs)
                sent_after.append((keys, vecs))
                for k, v in zip(keys, vecs):
                    want[int(k)] = v

            # The consumer's first attempts may hit the dead socket /
            # unknown-member fences; the production UpdateConsumer retries
            # with backoff — mirror that loop here.
            got = []
            deadline = time.time() + 10
            while time.time() < deadline:
                try:
                    got.extend(list(c.poll(10)))
                    if sum(k.shape[0] for _t, k, _v in got) >= 6:
                        break
                except (IOError, OSError):
                    time.sleep(0.1)
            apply(got)
            # The consumer re-registered with the NEW coordinator (its old
            # session died with the old broker).
            assert c._member_id in broker2.groups["g"]["members"]
            _ = member0
            # Exactly the post-failover batches: committed offsets
            # survived, so nothing was lost OR re-read.
            gk = np.sort(np.concatenate([k for _t, k, _v in got]))
            np.testing.assert_array_equal(
                gk, np.sort(np.concatenate([k for k, _ in sent_after])))
            c.commit()
            # Cache end state: every update applied exactly once.
            assert set(applied) == set(want)
            for k in want:
                np.testing.assert_array_equal(applied[k], want[k])
            c.close()
            prod2.close()
        finally:
            broker2.stop()
    finally:
        broker.stop()


def test_kafka_negative_message_size_rejected():
    """A corrupt/malicious negative size field must raise, not walk the
    reader backward forever (CRCs are deliberately unchecked)."""
    import struct

    from hugectr_backend_tpu_torch.update.kafka_lite import decode_message_set

    raw = struct.pack(">qi", 0, -5) + b"\x00" * 16
    with pytest.raises(IOError, match="invalid message size"):
        decode_message_set(raw)


def test_kafka_negotiate_unreachable_does_not_lock_v0():
    """A merely-unreachable broker must NOT be mistaken for a pre-0.10
    broker: the dialect stays unnegotiated so a later retry can pick v2
    (locking v0 would permanently break against a Kafka>=4.0 broker that
    started after us)."""
    import socket

    from hugectr_backend_tpu_torch.update.kafka_lite import KafkaClient

    with socket.socket() as s:  # grab a port, then close it -> refused
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    c = KafkaClient(f"127.0.0.1:{port}", timeout_s=1.0)
    with pytest.raises(IOError, match="unreachable"):
        c.negotiate()
    assert c.mode is None  # not locked; a retry renegotiates


def test_kafka_offset_out_of_range_resets(monkeypatch):
    """A stale offset past the broker's log start resets to earliest
    instead of wedging the consumer forever."""
    from hugectr_backend_tpu_torch.update.kafka_lite import (
        KafkaProtocolError,
        KafkaQueueSource,
    )
    from hugectr_backend_tpu_torch.update.mini_broker import MiniKafkaBroker

    broker = MiniKafkaBroker(num_partitions=1).start()
    try:
        prod = KafkaQueueSource(f"127.0.0.1:{broker.port}")
        keys = np.arange(3, dtype=np.int64)
        prod.post("hps_et.m.t0", keys, np.ones((3, 4), np.float32))

        c = KafkaQueueSource(f"127.0.0.1:{broker.port}")
        # Simulate a persisted offset past retention: way beyond the log,
        # with the broker reporting OFFSET_OUT_OF_RANGE (the mini broker
        # serves empty instead, so inject the error once at the client).
        c._offsets[("hps_et.m.t0", 0)] = 10_000
        real_fetch = c.client.fetch
        state = {"raised": False}

        def fetch(topic, pid, offset, **kw):
            if offset >= 10_000 and not state["raised"]:
                state["raised"] = True
                raise KafkaProtocolError("fetch", 1, f" on {topic}")
            return real_fetch(topic, pid, offset, **kw)

        monkeypatch.setattr(c.client, "fetch", fetch)
        got = list(c.poll(10))
        assert state["raised"]
        assert len(got) == 1
        np.testing.assert_array_equal(got[0][1], keys)
        c.close()
        prod.close()
    finally:
        broker.stop()


# ------------------------------------------------- the port against the JAX package


def _both(module: str):
    """(port module, JAX package module) of the same name."""
    import importlib

    return (importlib.import_module(f"hugectr_backend_tpu_torch.{module}"),
            importlib.import_module(f"hugectr_backend_tpu.{module}"))


def test_crc32c_identical_to_jax():
    port, ref = _both("update.record_batch")
    rng = np.random.default_rng(21)
    for n in (0, 1, 7, 8, 63, 4096, 100_003):
        blob = rng.bytes(n)
        seed = int(rng.integers(0, 2**32))
        assert port.crc32c(blob) == ref.crc32c(blob) == port._crc32c_py(blob)
        assert port.crc32c(blob, seed) == ref.crc32c(blob, seed)


@pytest.mark.parametrize("codec", ["none", "gzip", "snappy", "lz4", "zstd"])
def test_compressed_bytes_identical_to_jax(codec, monkeypatch):
    """Every encoder gives the JAX package's bytes (gzip's header carries the
    clock, so the clock is held still), and each package decodes the other's."""
    import time as _time

    monkeypatch.setattr(_time, "time", lambda: 1_700_000_000.0)
    pc, rc = _both("update.compression")
    prb, rrb = _both("update.record_batch")
    pk, rk = _both("update.kafka_lite")
    rng = np.random.default_rng(22)
    data = b"update " * 300 + rng.bytes(2048) + bytes(range(256)) * 8
    if codec != "none":
        assert pc.compress(codec, data) == rc.compress(codec, data)
        assert pc.decompress(codec, rc.compress(codec, data)) == data
        assert rc.decompress(codec, pc.compress(codec, data)) == data
    entries = [(b"k0", data[:700]), (None, b"null-key"), (b"k2", data)]
    c = None if codec == "none" else codec
    raw = prb.encode_record_batch(entries, base_offset=5, timestamp_ms=99, codec=c)
    assert raw == rrb.encode_record_batch(entries, base_offset=5, timestamp_ms=99,
                                          codec=c)
    assert prb.decode_record_batches(raw, verify_crc=True) == \
        rrb.decode_record_batches(raw, verify_crc=True)
    ms = pk.encode_message_set(entries, codec=c)
    assert ms == rk.encode_message_set(entries, codec=c)
    assert pk.decode_message_set(ms) == rk.decode_message_set(ms)
    keys = rng.integers(-2**62, 2**62, 37).astype(np.int64)
    vecs = rng.standard_normal((37, 16)).astype(np.float32)
    assert pk.encode_update(16, keys, vecs) == rk.encode_update(16, keys, vecs)


@pytest.mark.parametrize("dialect", ["v0", "v2"])
@pytest.mark.parametrize("producer_pkg", ["port", "jax"])
def test_cross_package_producer_and_broker(dialect, producer_pkg, tmp_path):
    """A port producer posts to the JAX package's mini broker and a JAX
    consumer reads it, and the other way round: the wire is the same."""
    pk, rk = _both("update.kafka_lite")
    pb, rb = _both("update.mini_broker")
    prod_k, cons_k, broker_m = (pk, rk, rb) if producer_pkg == "port" else (rk, pk, pb)
    broker = broker_m.MiniKafkaBroker(num_partitions=2, dialect=dialect).start()
    try:
        addr = f"127.0.0.1:{broker.port}"
        prod = prod_k.KafkaQueueSource(addr, compression="snappy")
        rng = np.random.default_rng(23)
        sent = []
        for i in range(3):
            keys = np.arange(5, dtype=np.int64) + 100 * i
            vecs = rng.standard_normal((5, 8)).astype(np.float32)
            prod.post(f"hps_et.m.t{i % 2}", keys, vecs)
            sent.append((f"hps_et.m.t{i % 2}", keys, vecs))
        cons = cons_k.KafkaQueueSource(addr, offsets_path=str(tmp_path / "off.json"))
        got = sorted(cons.poll(timeout_ms=10), key=lambda tkv: int(tkv[1][0]))
        assert len(got) == 3
        for (t0, k0, v0), (t1, k1, v1) in zip(sent, got):
            assert t0 == t1
            np.testing.assert_array_equal(k0, k1)
            np.testing.assert_array_equal(v0, v1)
        assert list(cons.poll(timeout_ms=10)) == []
        cons.close()
        prod.close()
    finally:
        broker.stop()


def test_cross_package_file_queue(tmp_path):
    """The file queue's on-disk layout is shared: each package reads what the
    other posted, and offsets committed by one are honoured by the other."""
    ps_, rs_ = _both("update.source")
    keys = np.arange(6, dtype=np.int64) * 3
    vecs = np.arange(24, dtype=np.float32).reshape(6, 4)
    ps_.FileQueueSource(tmp_path / "q").post("hps_et.m.t0", keys, vecs)
    rs_.FileQueueSource(tmp_path / "q").post("hps_et.m.t0", keys + 1, vecs * 2)
    r = rs_.FileQueueSource(tmp_path / "q")
    got_r = list(r.poll(0))
    p = ps_.FileQueueSource(tmp_path / "q")
    got_p = list(p.poll(0))
    assert len(got_r) == len(got_p) == 2
    for (ta, ka, va), (tb, kb, vb) in zip(got_r, got_p):
        assert ta == tb
        np.testing.assert_array_equal(ka, kb)
        np.testing.assert_array_equal(va, vb)
    p.commit()
    assert list(rs_.FileQueueSource(tmp_path / "q").poll(0)) == []
