"""In-process Kafka mini broker (single node, N partitions/topic).

Port of the JAX package's update/mini_broker.py (the same wire bytes and files).

Speaks the same protocol subset as update/kafka_lite.py — Produce, Fetch,
ListOffsets, Metadata plus ApiVersions(18) — in either wire dialect, so the
``kafka_message_queue`` transport can be integration-tested (and used as a
lightweight single-host queue) with no external broker:

  * ``dialect="v0"`` (default): the v0 request versions with MessageSet v0
    framing, like an Apache Kafka 0.8-3.x broker.
  * ``dialect="v2"``: Produce v3 / Fetch v4 / ListOffsets v1 / Metadata v4
    with magic=2 RecordBatch framing (update/record_batch.py) and the v0
    request versions REJECTED — like a Kafka >=4.0 broker after KIP-896.

Topics auto-create on first produce with ``num_partitions`` partitions;
logs are in-memory lists, offsets are dense per (topic, partition).

    broker = MiniKafkaBroker(num_partitions=3).start()   # broker.port
    ...
    broker.stop()
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Optional

from hugectr_backend_tpu_torch.update.kafka_lite import (
    _Reader,
    _enc_bytes,
    _enc_str,
    decode_message_set,
    encode_message_set,
)
from hugectr_backend_tpu_torch.update.record_batch import (
    decode_record_batches,
    encode_record_batch,
)


class MiniKafkaBroker:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 num_partitions: int = 1, dialect: str = "v0",
                 fetch_codec: "str | int | None" = 0):
        assert dialect in ("v0", "v2"), dialect
        self.host = host
        self.dialect = dialect
        # Compressed-produce mode: fetch responses re-encode records with
        # this codec, simulating a topic written by a compressing producer
        # (gzip/snappy/lz4/zstd).
        self.fetch_codec = fetch_codec
        self.num_partitions = max(int(num_partitions), 1)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(16)
        self.port = self._srv.getsockname()[1]
        # (topic, partition) -> list of (key|None, value); offset == index
        self.logs: dict[tuple[str, int], list] = {}
        self._lock = threading.Lock()
        # Consumer-group coordinator state (JoinGroup barrier semantics:
        # a join opens a short rebalance window; the generation bumps ONCE
        # when every known member has rejoined or the window closes, and
        # members that missed the window are dropped — the real broker's
        # join-phase behavior, simplified).
        self.groups: dict[str, dict] = {}
        self.group_offsets: dict[tuple[str, str, int], int] = {}
        self._gcv = threading.Condition()
        self.rebalance_window_s = 0.5
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._conns: list[socket.socket] = []
        self._accept_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- control

    def start(self) -> "MiniKafkaBroker":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="mini-kafka-accept"
        )
        self._accept_thread.start()
        return self

    def stop(self):
        self._stop.set()
        # Wake handlers parked in the rebalance-barrier condition waits
        # (their predicates check _stop), or the join loop below stalls
        # its timeout per waiting handler.
        with self._gcv:
            self._gcv.notify_all()
        # shutdown() wakes the thread blocked in accept() — close() alone
        # leaves it parked in the syscall, which keeps the kernel's LISTEN
        # socket alive and blocks a failover broker from rebinding the port.
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2)
        # Close live connection sockets too: handler threads block in recv
        # and would otherwise pin ESTABLISHED sockets on this port, which
        # blocks a failover broker from rebinding the same address (the
        # coordinator-failover fault tests restart on the same port).
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=2)

    # ------------------------------------------------------------- serving

    def _accept_loop(self):
        import errno

        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError as e:
                # Transient accept errors (fd exhaustion, client RST on
                # some platforms) must not silently kill the broker.
                if not self._stop.is_set() and e.errno in (
                    errno.EMFILE, errno.ENFILE, errno.ECONNABORTED,
                    errno.EINTR,
                ):
                    time.sleep(0.05)
                    continue
                return
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True,
                name="mini-kafka-conn",
            )
            t.start()
            # Prune finished handlers so a long-lived broker doesn't pin an
            # ever-growing list of dead Thread objects (and their sockets).
            with self._lock:
                self._threads = [x for x in self._threads if x.is_alive()]
                self._threads.append(t)
                self._conns = [c for c in self._conns if c.fileno() != -1]
                self._conns.append(conn)

    def _serve_conn(self, conn: socket.socket):
        try:
            while not self._stop.is_set():
                hdr = self._recv_n(conn, 4)
                if hdr is None:
                    return
                (n,) = struct.unpack(">i", hdr)
                payload = self._recv_n(conn, n)
                if payload is None:
                    return
                resp = self._handle(payload)
                conn.sendall(struct.pack(">i", len(resp)) + resp)
        except OSError:
            pass
        except Exception:  # pragma: no cover - protocol debugging aid
            from hugectr_backend_tpu_torch.utils.logging import get_logger

            get_logger("hps_tpu.kafka").exception(
                "mini broker connection handler failed"
            )
        finally:
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _recv_n(conn, n) -> Optional[bytes]:
        buf = bytearray()
        while len(buf) < n:
            try:
                chunk = conn.recv(n - len(buf))
            except OSError:
                return None
            if not chunk:
                return None
            buf += chunk
        return bytes(buf)

    # ------------------------------------------------------------- handlers

    # Request versions each dialect accepts, per api key.
    _GROUP_VERSIONS = {8: 1, 9: 1, 10: 0, 11: 0, 12: 0, 13: 0, 14: 0}
    _VERSIONS = {
        "v0": {0: 0, 1: 0, 2: 0, 3: 0, **_GROUP_VERSIONS},
        "v2": {0: 3, 1: 4, 2: 1, 3: 4, **_GROUP_VERSIONS},
    }

    def _handle(self, payload: bytes) -> bytes:
        r = _Reader(payload)
        api = r.i16()
        version = r.i16()
        corr = r.i32()
        r.string()  # client_id
        if api != 18 and version != self._VERSIONS[self.dialect].get(api):
            raise IOError(
                f"mini broker dialect {self.dialect} rejects api {api}"
                f" v{version}"
            )
        v2 = self.dialect == "v2"
        body = {
            0: self._produce_v3 if v2 else self._produce,
            1: self._fetch_v4 if v2 else self._fetch,
            2: self._list_offsets_v1 if v2 else self._list_offsets,
            3: self._metadata_v4 if v2 else self._metadata,
            8: self._offset_commit,
            9: self._offset_fetch,
            10: self._find_coordinator,
            11: self._join_group,
            12: self._heartbeat,
            13: self._leave_group,
            14: self._sync_group,
            18: self._api_versions,
        }[api](r)
        return struct.pack(">i", corr) + body

    def _api_versions(self, r: _Reader) -> bytes:
        if self.dialect == "v2":
            # A post-KIP-896 broker: v0 request versions are gone.
            apis = [(0, 3, 9), (1, 4, 13), (2, 1, 8), (3, 1, 12),
                    (8, 0, 8), (9, 0, 8), (10, 0, 4), (11, 0, 9),
                    (12, 0, 4), (13, 0, 5), (14, 0, 5), (18, 0, 3)]
        else:
            apis = [(0, 0, 0), (1, 0, 0), (2, 0, 0), (3, 0, 0),
                    (8, 0, 1), (9, 0, 1), (10, 0, 0), (11, 0, 0),
                    (12, 0, 0), (13, 0, 0), (14, 0, 0), (18, 0, 0)]
        out = struct.pack(">hi", 0, len(apis))
        for api, lo, hi in apis:
            out += struct.pack(">hhh", api, lo, hi)
        return out

    def _metadata_names(self, want):
        with self._lock:
            return want or sorted({t for t, _ in self.logs})

    def _metadata(self, r: _Reader) -> bytes:
        want = [r.string() for _ in range(r.i32())]
        names = self._metadata_names(want)
        out = struct.pack(">i", 1)  # one broker
        out += struct.pack(">i", 0) + _enc_str(self.host) + struct.pack(
            ">i", self.port
        )
        out += struct.pack(">i", len(names))
        for name in names:
            out += struct.pack(">h", 0) + _enc_str(name)
            out += struct.pack(">i", self.num_partitions)
            for pid in range(self.num_partitions):
                out += struct.pack(">hii", 0, pid, 0)  # err, id, leader
                out += struct.pack(">i", 1) + struct.pack(">i", 0)
                out += struct.pack(">i", 1) + struct.pack(">i", 0)
        return out

    def _metadata_v4(self, r: _Reader) -> bytes:
        n = r.i32()  # nullable: -1 (or 0) == all topics
        want = [r.string() for _ in range(max(n, 0))]
        r.i8()  # allow_auto_topic_creation
        names = self._metadata_names(want)
        out = struct.pack(">i", 0)  # throttle_time_ms
        out += struct.pack(">i", 1)  # one broker
        out += struct.pack(">i", 0) + _enc_str(self.host)
        out += struct.pack(">i", self.port) + _enc_str(None)  # rack
        out += _enc_str("mini-cluster") + struct.pack(">i", 0)  # controller
        out += struct.pack(">i", len(names))
        for name in names:
            out += struct.pack(">h", 0) + _enc_str(name)
            out += struct.pack(">b", 0)  # is_internal
            out += struct.pack(">i", self.num_partitions)
            for pid in range(self.num_partitions):
                out += struct.pack(">hii", 0, pid, 0)  # err, id, leader
                out += struct.pack(">i", 1) + struct.pack(">i", 0)
                out += struct.pack(">i", 1) + struct.pack(">i", 0)
        return out

    def _produce(self, r: _Reader) -> bytes:
        r.i16()  # acks
        r.i32()  # timeout
        out_topics = b""
        ntopics = r.i32()
        for _ in range(ntopics):
            topic = r.string()
            nparts = r.i32()
            parts_out = b""
            for _ in range(nparts):
                pid = r.i32()
                ms = r.take(r.i32())
                msgs = decode_message_set(ms)
                if not 0 <= pid < self.num_partitions:
                    parts_out += struct.pack(">ihq", pid, 3, -1)  # UNKNOWN
                    continue
                with self._lock:
                    log = self.logs.setdefault((topic, pid), [])
                    base = len(log)
                    for _off, key, value in msgs:
                        log.append((key, value))
                parts_out += struct.pack(">ihq", pid, 0, base)
            out_topics += _enc_str(topic) + struct.pack(">i", nparts) + parts_out
        return struct.pack(">i", ntopics) + out_topics

    def _fetch(self, r: _Reader) -> bytes:
        r.i32()  # replica
        r.i32()  # max_wait
        r.i32()  # min_bytes
        ntopics = r.i32()
        out = struct.pack(">i", ntopics)
        for _ in range(ntopics):
            topic = r.string()
            nparts = r.i32()
            out += _enc_str(topic) + struct.pack(">i", nparts)
            for _ in range(nparts):
                pid = r.i32()
                offset = r.i64()
                max_bytes = r.i32()
                with self._lock:
                    log = self.logs.get((topic, pid), [])
                    hw = len(log)
                    entries = log[offset : offset + 1000]
                # Re-encode with REAL offsets.
                ms = b""
                if self.fetch_codec and entries:
                    # One compressed wrapper holding the whole run; the
                    # wrapper offset is the LAST inner offset (broker
                    # convention for magic>=0 down-conversion).
                    one = encode_message_set(
                        list(entries), codec=self.fetch_codec)
                    ms = struct.pack(
                        ">q", offset + len(entries) - 1) + one[8:]
                else:
                    for i, (key, value) in enumerate(entries):
                        one = encode_message_set([(key, value)])
                        # patch the placeholder -1 offset
                        ms += struct.pack(">q", offset + i) + one[8:]
                        if len(ms) >= max_bytes:
                            break
                out += struct.pack(">ihq", pid, 0, hw) + _enc_bytes(ms)
        return out

    def _list_offsets(self, r: _Reader) -> bytes:
        r.i32()  # replica
        ntopics = r.i32()
        out = struct.pack(">i", ntopics)
        for _ in range(ntopics):
            topic = r.string()
            nparts = r.i32()
            out += _enc_str(topic) + struct.pack(">i", nparts)
            for _ in range(nparts):
                pid = r.i32()
                time_ms = r.i64()
                r.i32()  # max offsets
                with self._lock:
                    log = self.logs.get((topic, pid), [])
                    off = 0 if time_ms == -2 else len(log)
                out += struct.pack(">ih", pid, 0)
                out += struct.pack(">i", 1) + struct.pack(">q", off)
        return out

    # -------------------------------------------------- v2-dialect handlers

    def _produce_v3(self, r: _Reader) -> bytes:
        r.string()  # transactional_id (nullable)
        r.i16()  # acks
        r.i32()  # timeout
        out_topics = b""
        ntopics = r.i32()
        for _ in range(ntopics):
            topic = r.string()
            nparts = r.i32()
            parts_out = b""
            for _ in range(nparts):
                pid = r.i32()
                ms = r.bytes_() or b""
                msgs = decode_record_batches(ms, verify_crc=True)
                if not 0 <= pid < self.num_partitions:
                    parts_out += struct.pack(">ihqq", pid, 3, -1, -1)
                    continue
                with self._lock:
                    log = self.logs.setdefault((topic, pid), [])
                    base = len(log)
                    for _off, key, value in msgs:
                        log.append((key, value))
                # err, base_offset, log_append_time
                parts_out += struct.pack(">ihqq", pid, 0, base, -1)
            out_topics += _enc_str(topic) + struct.pack(">i", nparts) + parts_out
        return (struct.pack(">i", ntopics) + out_topics
                + struct.pack(">i", 0))  # throttle_time_ms

    def _fetch_v4(self, r: _Reader) -> bytes:
        r.i32()  # replica
        r.i32()  # max_wait
        r.i32()  # min_bytes
        r.i32()  # max_bytes (response total)
        r.i8()  # isolation_level
        ntopics = r.i32()
        out = struct.pack(">i", 0)  # throttle_time_ms
        out += struct.pack(">i", ntopics)
        for _ in range(ntopics):
            topic = r.string()
            nparts = r.i32()
            out += _enc_str(topic) + struct.pack(">i", nparts)
            for _ in range(nparts):
                pid = r.i32()
                offset = r.i64()
                max_bytes = r.i32()
                with self._lock:
                    log = self.logs.get((topic, pid), [])
                    hw = len(log)
                    entries = log[offset : offset + 1000]
                # One single-record batch per message (real brokers return
                # whatever batch boundaries the producer sent; per-record
                # batches exercise the client's multi-batch decode). In
                # fetch_codec mode, one compressed MULTI-record batch.
                ms = b""
                if self.fetch_codec and entries:
                    ms = encode_record_batch(list(entries),
                                             base_offset=offset,
                                             codec=self.fetch_codec)
                else:
                    for i, (key, value) in enumerate(entries):
                        ms += encode_record_batch([(key, value)],
                                                  base_offset=offset + i)
                        if len(ms) >= max_bytes:
                            break
                out += struct.pack(">ihqq", pid, 0, hw, hw)  # err, hw, lso
                out += struct.pack(">i", -1)  # aborted_transactions: null
                out += _enc_bytes(ms)
        return out

    def _list_offsets_v1(self, r: _Reader) -> bytes:
        r.i32()  # replica
        ntopics = r.i32()
        out = struct.pack(">i", ntopics)
        for _ in range(ntopics):
            topic = r.string()
            nparts = r.i32()
            out += _enc_str(topic) + struct.pack(">i", nparts)
            for _ in range(nparts):
                pid = r.i32()
                time_ms = r.i64()
                with self._lock:
                    log = self.logs.get((topic, pid), [])
                    off = 0 if time_ms == -2 else len(log)
                # err, timestamp, offset
                out += struct.pack(">ihqq", pid, 0, -1, off)
        return out

    # ------------------------------------------------- group coordination

    def _group(self, name: str) -> dict:
        return self.groups.setdefault(name, {
            "members": {}, "generation": 0, "assignments": {},
            "state": "stable", "joined": set(), "counter": 0, "round": 0,
            "deadline": 0.0,
        })

    def _find_coordinator(self, r: _Reader) -> bytes:
        r.string()  # group (single-node: we coordinate everything)
        return (struct.pack(">hi", 0, 0) + _enc_str(self.host)
                + struct.pack(">i", self.port))

    def _join_group(self, r: _Reader) -> bytes:
        group = r.string()
        r.i32()  # session_timeout_ms
        member_id = r.string() or ""
        r.string()  # protocol_type
        meta = b""
        for i in range(r.i32()):
            name = r.string()
            blob = r.bytes_() or b""
            if i == 0:
                _ = name
                meta = blob
        with self._gcv:
            g = self._group(group)
            if not member_id:
                g["counter"] += 1
                member_id = f"{group}-member-{g['counter']}"
            known_before = set(g["members"])
            g["members"][member_id] = meta
            if g["state"] != "joining":
                g["state"] = "joining"
                g["joined"] = set()
                g["deadline"] = time.monotonic() + self.rebalance_window_s
                # Early barrier exit once every member known BEFORE this
                # rebalance has rejoined; a FRESH group ({} before) waits
                # the full window so concurrent first joiners coalesce
                # into one generation (group.initial.rebalance.delay).
                g["expected"] = known_before | {member_id}
                g["fresh"] = len(known_before) == 0
            g["joined"].add(member_id)
            my_round = g["round"]
            self._gcv.notify_all()
            while (not self._stop.is_set()
                   and g["state"] == "joining" and g["round"] == my_round
                   and not (not g["fresh"]
                            and g["joined"] >= g["expected"])
                   and time.monotonic() < g["deadline"]):
                self._gcv.wait(0.05)
            if g["state"] == "joining" and g["round"] == my_round:
                # Barrier complete: drop members that missed the window,
                # bump the generation ONCE, await the leader's sync.
                g["members"] = {m: g["members"][m] for m in sorted(g["joined"])}
                g["generation"] += 1
                g["assignments"] = {}
                g["state"] = "awaiting_sync"
                g["round"] += 1
                self._gcv.notify_all()
            leader = sorted(g["members"])[0]
            gen = g["generation"]
            members = (sorted(g["members"].items())
                       if member_id == leader else [])
        out = (struct.pack(">hi", 0, gen) + _enc_str("range")
               + _enc_str(leader) + _enc_str(member_id))
        out += struct.pack(">i", len(members))
        for m, blob in members:
            out += _enc_str(m) + _enc_bytes(blob)
        return out

    def _sync_group(self, r: _Reader) -> bytes:
        group = r.string()
        gen = r.i32()
        member_id = r.string()
        assignments = {}
        for _ in range(r.i32()):
            m = r.string()
            assignments[m] = r.bytes_() or b""
        with self._gcv:
            g = self._group(group)
            if member_id not in g["members"]:
                return struct.pack(">h", 25) + _enc_bytes(b"")  # UNKNOWN_MEMBER
            if gen != g["generation"]:
                return struct.pack(">h", 22) + _enc_bytes(b"")  # ILLEGAL_GEN
            if assignments:  # leader
                g["assignments"] = assignments
                g["state"] = "stable"
                self._gcv.notify_all()
            deadline = time.monotonic() + 5.0
            while (not self._stop.is_set()
                   and not g["assignments"] and g["generation"] == gen
                   and time.monotonic() < deadline):
                self._gcv.wait(0.05)
            if g["generation"] != gen:
                return struct.pack(">h", 22) + _enc_bytes(b"")
            if not g["assignments"]:
                return struct.pack(">h", 27) + _enc_bytes(b"")  # REBALANCE
            return (struct.pack(">h", 0)
                    + _enc_bytes(g["assignments"].get(member_id, b"")))

    def _heartbeat(self, r: _Reader) -> bytes:
        group = r.string()
        gen = r.i32()
        member_id = r.string()
        with self._gcv:
            g = self.groups.get(group)
            if g is None or member_id not in g["members"]:
                return struct.pack(">h", 25)
            if g["state"] != "stable":
                return struct.pack(">h", 27)
            if gen != g["generation"]:
                return struct.pack(">h", 22)
        return struct.pack(">h", 0)

    def _leave_group(self, r: _Reader) -> bytes:
        group = r.string()
        member_id = r.string()
        with self._gcv:
            g = self.groups.get(group)
            if g and member_id in g["members"]:
                del g["members"][member_id]
                g["joined"].discard(member_id)
                # Remaining members rebalance on their next heartbeat.
                if g["members"]:
                    g["state"] = "joining"
                    g["joined"] = set()
                    g["deadline"] = (time.monotonic()
                                     + self.rebalance_window_s)
                else:
                    g["state"] = "stable"
                    g["assignments"] = {}
                self._gcv.notify_all()
        return struct.pack(">h", 0)

    def _offset_commit(self, r: _Reader) -> bytes:
        # v1: group | generation | member_id | topics[partition, offset,
        # timestamp, metadata]. Generation fencing: a stale member's late
        # commit (pre-rebalance generation) is rejected with 22 so it
        # cannot rewind the new partition owner's progress.
        group = r.string()
        generation = r.i32()
        member_id = r.string()
        with self._gcv:
            g = self.groups.get(group)
            fence = (
                g is not None and generation >= 0
                and (generation != g["generation"]
                     or member_id not in g["members"])
            )
        ntop = r.i32()
        out = struct.pack(">i", ntop)
        for _ in range(ntop):
            topic = r.string()
            nparts = r.i32()
            out += _enc_str(topic) + struct.pack(">i", nparts)
            for _ in range(nparts):
                pid = r.i32()
                off = r.i64()
                r.i64()  # timestamp
                r.string()  # metadata
                if fence:
                    out += struct.pack(">ih", pid, 22)  # ILLEGAL_GENERATION
                    continue
                with self._gcv:
                    self.group_offsets[(group, topic, pid)] = off
                out += struct.pack(">ih", pid, 0)
        return out

    def _offset_fetch(self, r: _Reader) -> bytes:
        group = r.string()
        ntop = r.i32()
        out = struct.pack(">i", ntop)
        for _ in range(ntop):
            topic = r.string()
            nparts = r.i32()
            out += _enc_str(topic) + struct.pack(">i", nparts)
            for _ in range(nparts):
                pid = r.i32()
                with self._gcv:
                    off = self.group_offsets.get((group, topic, pid), -1)
                out += struct.pack(">iq", pid, off) + _enc_str("") \
                    + struct.pack(">h", 0)
        return out
