"""Cross-host volatile (DRAM) tier: a TCP-sharded key-value pool.

Port of the JAX package's tiers/cluster.py, wire format byte for byte (a node
of either package serves a client of the other), standing in for the
reference's ``redis_cluster`` volatile database (reference
docs/hierarchical_parameter_server.md:423-458; docs/architecture.md:131-137):
the DRAM of several hosts pools into one logical tier, tables partitioned
across nodes by key low bits — the reference's partitioning scheme — with
bulk query/insert chunked by ``max_batch_size`` (doc:446-448) exactly like
its Redis client. It is host code: the device cache above it is unchanged.

Two halves:

- :class:`ClusterNodeServer` — runs on each pool host
  (``python -m hugectr_backend_tpu_torch.tiers.cluster --port 7000``),
  serving a local DRAM store (the port's native C++ store,
  ``native/kvstore.py NativeDramKVTier``) over a length-prefixed binary
  protocol. This replaces the Redis server + hiredis
  RPC of the reference.
- :class:`ClusterKVTier` — the KVTier client: routes each key to
  ``node = key % n_nodes``, fans batched sub-requests to the owner nodes in
  parallel, merges results. Plugs in behind the same KVTier interface the
  rest of the PS uses, so the device cache / SSD cascade is unchanged.

Wire format (little-endian):
    request : [u32 len][u8 op][u16 tag_len][tag][op payload]
    response: [u32 len][u8 status][payload]

Ops: PING, CREATE(dim i32), DROP, INSERT(n i64, keys n*i64, vecs n*dim*f32),
QUERY(n i64, keys) -> (found n*u8, vecs n*dim*f32), KEYS -> (n, keys),
SIZE -> i64, TABLES -> joined tag list.

Security (the reference's redis_cluster supports password auth + TLS,
reference docs/hierarchical_parameter_server.md:450-458):

- **Shared secret** (``secret=...`` on server and client; ps.json
  ``volatile_db.password`` plumbs here): challenge-response handshake on
  connect — the server sends a random nonce, the client must answer
  HMAC-SHA256(secret, nonce) before any op is accepted. Unauthenticated
  peers (including DROP attempts) are disconnected. Both sides must agree
  on whether a secret is configured.
- **TLS** (``volatile_db.enable_tls`` + the ``tls_*`` cert paths): the
  whole connection wraps in ``ssl`` before the handshake; combine with the
  secret for mutual trust without client certs, or use CA-verified client
  certs via a custom ``ssl.SSLContext``.
"""

from __future__ import annotations

import hmac
import hashlib
import os
import socket
import ssl
import struct
import threading
from typing import Optional

import numpy as np

from hugectr_backend_tpu_torch.tiers.base import KVTier
from hugectr_backend_tpu_torch.utils.logging import get_logger

log = get_logger("hps_tpu.cluster")

_AUTH_MAGIC = b"HPSA"
_NONCE_LEN = 16


def _auth_digest(secret: str, nonce: bytes) -> bytes:
    return hmac.new(secret.encode(), nonce, hashlib.sha256).digest()

OP_PING, OP_CREATE, OP_DROP, OP_INSERT, OP_QUERY, OP_KEYS, OP_SIZE, \
    OP_TABLES = range(8)
ST_OK, ST_ERR = 0, 1


def _recv_n(sock, n) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 20, n - len(buf)))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _send_msg(sock, payload: bytes):
    sock.sendall(struct.pack("<I", len(payload)) + payload)


def _recv_msg(sock) -> Optional[bytes]:
    hdr = _recv_n(sock, 4)
    if hdr is None:
        return None
    (n,) = struct.unpack("<I", hdr)
    return _recv_n(sock, n)


class ClusterNodeServer:
    """One pool node: a local DRAM store served over TCP."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, store=None,
                 secret: Optional[str] = None,
                 tls: Optional[ssl.SSLContext] = None):
        if store is None:
            from hugectr_backend_tpu_torch.native.kvstore import NativeDramKVTier

            store = NativeDramKVTier()
        self.store = store
        self.secret = secret or None
        self.tls = tls
        self._dims: dict[str, int] = {}
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._accept: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def start(self) -> "ClusterNodeServer":
        self._accept = threading.Thread(
            target=self._accept_loop, daemon=True, name="hps-cluster-accept"
        )
        self._accept.start()
        return self

    def stop(self):
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        for t in self._threads:
            t.join(timeout=2)

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            t = threading.Thread(
                target=self._serve, args=(conn,), daemon=True,
                name="hps-cluster-conn",
            )
            t.start()
            # Prune finished handlers so a long-lived node doesn't pin an
            # ever-growing list of dead Thread objects.
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)

    def _serve(self, conn):
        try:
            if self.tls is not None:
                conn = self.tls.wrap_socket(conn, server_side=True)
            if self.secret is not None and not self._authenticate(conn):
                log.warning("cluster node: rejected unauthenticated peer")
                return
            while not self._stop.is_set():
                msg = _recv_msg(conn)
                if msg is None:
                    return
                try:
                    resp = self._handle(msg)
                except Exception as e:
                    log.exception("cluster node op failed")
                    resp = bytes([ST_ERR]) + str(e).encode()[:512]
                _send_msg(conn, resp)
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _authenticate(self, conn) -> bool:
        """Challenge-response: send nonce, require HMAC-SHA256(secret, nonce)
        back before serving any op (reference redis auth parity, doc:450-458)."""
        nonce = os.urandom(_NONCE_LEN)
        _send_msg(conn, _AUTH_MAGIC + nonce)
        reply = _recv_msg(conn)
        if reply is None or not hmac.compare_digest(
            reply, _auth_digest(self.secret, nonce)
        ):
            _send_msg(conn, bytes([ST_ERR]) + b"authentication failed")
            return False
        _send_msg(conn, bytes([ST_OK]))
        return True

    def _handle(self, msg: bytes) -> bytes:
        op = msg[0]
        (tag_len,) = struct.unpack_from("<H", msg, 1)
        tag = msg[3 : 3 + tag_len].decode()
        body = msg[3 + tag_len :]
        if op == OP_PING:
            return bytes([ST_OK])
        if op == OP_CREATE:
            (dim,) = struct.unpack("<i", body)
            with self._lock:
                self.store.create_table(tag, dim)
                self._dims[tag] = dim
            return bytes([ST_OK])
        if op == OP_DROP:
            with self._lock:
                self.store.drop_table(tag)
                self._dims.pop(tag, None)
            return bytes([ST_OK])
        if op == OP_INSERT:
            (n,) = struct.unpack_from("<q", body, 0)
            keys = np.frombuffer(body, "<i8", n, 8).copy()
            dim = self._dims.get(tag)
            if dim is None:
                vecs = np.frombuffer(body, "<f4", -1, 8 + 8 * n)
                dim = vecs.shape[0] // max(n, 1)
                with self._lock:
                    self.store.create_table(tag, dim)
                    self._dims[tag] = dim
                vecs = vecs.reshape(n, dim).copy()
            else:
                vecs = np.frombuffer(
                    body, "<f4", n * dim, 8 + 8 * n
                ).reshape(n, dim).copy()
            self.store.insert(tag, keys, vecs)
            return bytes([ST_OK])
        if op == OP_QUERY:
            (n,) = struct.unpack_from("<q", body, 0)
            keys = np.frombuffer(body, "<i8", n, 8).copy()
            if tag not in self.store.tables():
                # Unknown/dropped table -> all-miss (redis GET semantics).
                dim = self._dims.get(tag, 0)
                return (
                    bytes([ST_OK])
                    + np.zeros(n, np.uint8).tobytes()
                    + np.zeros(n * dim, "<f4").tobytes()
                )
            vecs, found = self.store.query(tag, keys)
            return (
                bytes([ST_OK])
                + found.astype(np.uint8).tobytes()
                + np.ascontiguousarray(vecs, "<f4").tobytes()
            )
        if op == OP_KEYS:
            if tag not in self.store.tables():
                return bytes([ST_OK]) + struct.pack("<q", 0)
            keys = self.store.keys(tag)
            return (
                bytes([ST_OK])
                + struct.pack("<q", keys.shape[0])
                + np.ascontiguousarray(keys, "<i8").tobytes()
            )
        if op == OP_SIZE:
            size = (
                self.store.size(tag) if tag in self.store.tables() else 0
            )
            return bytes([ST_OK]) + struct.pack("<q", size)
        if op == OP_TABLES:
            return bytes([ST_OK]) + "\n".join(self.store.tables()).encode()
        raise ValueError(f"unknown op {op}")


class _NodeClient:
    def __init__(self, addr: "tuple[str, int]", timeout_s: float = 10.0,
                 secret: Optional[str] = None,
                 tls: Optional[ssl.SSLContext] = None,
                 server_hostname: Optional[str] = None):
        self.addr = addr
        self.timeout_s = timeout_s
        self.secret = secret or None
        self.tls = tls
        self.server_hostname = server_hostname
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _ensure(self):
        if self._sock is None:
            sock = socket.create_connection(self.addr, timeout=self.timeout_s)
            try:
                if self.tls is not None:
                    sock = self.tls.wrap_socket(
                        sock, server_hostname=self.server_hostname
                    )
                if self.secret is not None:
                    self._handshake(sock)
            except BaseException:
                sock.close()
                raise
            self._sock = sock
        return self._sock

    def _handshake(self, sock):
        greeting = _recv_msg(sock)
        if greeting is None or greeting[:4] != _AUTH_MAGIC:
            raise IOError(
                f"cluster node {self.addr} did not offer an auth challenge "
                "(secret configured on the client but not the node?)"
            )
        _send_msg(sock, _auth_digest(self.secret, greeting[4:]))
        ack = _recv_msg(sock)
        if ack is None or ack[0] != ST_OK:
            raise IOError(f"cluster node {self.addr} rejected the secret")

    def call(self, op: int, tag: str, body: bytes = b"") -> bytes:
        t = tag.encode()
        msg = bytes([op]) + struct.pack("<H", len(t)) + t + body
        with self._lock:
            try:
                s = self._ensure()
                _send_msg(s, msg)
                resp = _recv_msg(s)
            except OSError:
                self._close_locked()
                s = self._ensure()  # one reconnect attempt
                _send_msg(s, msg)
                resp = _recv_msg(s)
        if resp is None:
            raise IOError(f"cluster node {self.addr} closed connection")
        if resp[0] != ST_OK:
            raise IOError(
                f"cluster node {self.addr} error: {resp[1:].decode(errors='replace')}"
            )
        return resp[1:]

    def _close_locked(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self):
        with self._lock:
            self._close_locked()


class ClusterKVTier(KVTier):
    """KVTier over a pool of ClusterNodeServers; keys partitioned by low
    bits (``key % n_nodes``, the reference's Redis partitioning scheme)."""

    def __init__(self, addresses: "list[str]", max_batch_size: int = 65536,
                 timeout_s: float = 10.0, secret: Optional[str] = None,
                 tls: Optional[ssl.SSLContext] = None,
                 server_hostname: Optional[str] = None):
        if not addresses:
            raise ValueError("cluster tier needs at least one node address")
        self._nodes = []
        for a in addresses:
            host, _, port = a.strip().rpartition(":")
            self._nodes.append(
                _NodeClient((host or "127.0.0.1", int(port)), timeout_s,
                            secret=secret, tls=tls,
                            server_hostname=server_hostname)
            )
        self.n = len(self._nodes)
        self.max_batch = max(int(max_batch_size), 1)
        self._dims: dict[str, int] = {}

    # -- helpers -----------------------------------------------------------

    def ping(self) -> bool:
        for c in self._nodes:
            c.call(OP_PING, "")
        return True

    def _owner(self, keys: np.ndarray) -> np.ndarray:
        # Low-bits partitioning; abs() keeps negative keys routable.
        return (np.abs(keys) % self.n).astype(np.int64)

    # -- KVTier interface --------------------------------------------------

    def create_table(self, tag: str, dim: int) -> None:
        body = struct.pack("<i", dim)
        for c in self._nodes:
            c.call(OP_CREATE, tag, body)
        self._dims[tag] = dim

    def drop_table(self, tag: str) -> None:
        for c in self._nodes:
            c.call(OP_DROP, tag)
        self._dims.pop(tag, None)

    def tables(self) -> "list[str]":
        # Union over EVERY node: after one node restarts blank, the others
        # still hold their shards — reporting only node 0's view made
        # query() short-circuit to all-miss for tables the pool still has.
        names: set = set()
        for node in self._nodes:
            try:
                raw = node.call(OP_TABLES, "")
            except OSError:
                continue
            names.update(t for t in raw.decode().split("\n") if t)
        return sorted(names)

    def insert(self, tag: str, keys: np.ndarray, vectors: np.ndarray) -> int:
        keys = np.asarray(keys, np.int64).reshape(-1)
        vectors = np.asarray(vectors, np.float32).reshape(keys.shape[0], -1)
        if tag not in self._dims:
            self.create_table(tag, int(vectors.shape[1]))
        owner = self._owner(keys)
        total = 0
        for node in range(self.n):
            sel = np.flatnonzero(owner == node)
            for i in range(0, sel.size, self.max_batch):
                part = sel[i : i + self.max_batch]
                body = (
                    struct.pack("<q", part.size)
                    + np.ascontiguousarray(keys[part], "<i8").tobytes()
                    + np.ascontiguousarray(vectors[part], "<f4").tobytes()
                )
                self._nodes[node].call(OP_INSERT, tag, body)
                total += part.size
        return total

    def query(self, tag: str, keys: np.ndarray):
        keys = np.asarray(keys, np.int64).reshape(-1)
        dim = self._dims.get(tag)
        if dim is None:
            # Discover dim lazily from any node's keys/meta via a 0-key
            # insert being impossible: fall back to per-node query once a
            # table exists. Unknown table -> all-miss.
            if tag not in self.tables():
                return (
                    np.zeros((keys.shape[0], 0), np.float32),
                    np.zeros(keys.shape[0], bool),
                )
        out = None
        found = np.zeros(keys.shape[0], bool)
        owner = self._owner(keys)
        # Fan sub-queries to owner nodes in parallel (the reference chunks
        # Redis requests the same way, doc:446-448).
        results: dict[int, "list[tuple[np.ndarray, bytes]]"] = {}
        lock = threading.Lock()
        errs: list = []

        def ask(node: int):
            try:
                sel = np.flatnonzero(owner == node)
                parts = []
                for i in range(0, sel.size, self.max_batch):
                    part = sel[i : i + self.max_batch]
                    body = struct.pack("<q", part.size) + np.ascontiguousarray(
                        keys[part], "<i8"
                    ).tobytes()
                    parts.append((part, self._nodes[node].call(OP_QUERY, tag, body)))
                with lock:
                    results[node] = parts
            except Exception as e:
                with lock:
                    errs.append(e)

        threads = [
            threading.Thread(target=ask, args=(nd,), daemon=True)
            for nd in range(self.n)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        for node, parts in results.items():
            for part, raw in parts:
                f = np.frombuffer(raw, np.uint8, part.size).astype(bool)
                vecs = np.frombuffer(raw, "<f4", -1, part.size)
                d = vecs.shape[0] // max(part.size, 1)
                if d == 0:
                    # A restarted/blank node answered "unknown table" with
                    # dim-0 vectors: treat its keys as misses instead of
                    # failing the whole cross-host query.
                    continue
                if out is None:
                    dim = d
                    self._dims.setdefault(tag, d)
                    out = np.zeros((keys.shape[0], d), np.float32)
                out[part] = vecs.reshape(part.size, d)
                found[part] = f
        if out is None:
            out = np.zeros((keys.shape[0], dim or 0), np.float32)
        return out, found

    def keys(self, tag: str) -> np.ndarray:
        parts = []
        for c in self._nodes:
            raw = c.call(OP_KEYS, tag)
            (n,) = struct.unpack_from("<q", raw, 0)
            parts.append(np.frombuffer(raw, "<i8", n, 8))
        return np.sort(np.concatenate(parts)) if parts else np.zeros(0, np.int64)

    def size(self, tag: str) -> int:
        total = 0
        for c in self._nodes:
            (n,) = struct.unpack("<q", c.call(OP_SIZE, tag))
            total += n
        return total

    def close(self):
        for c in self._nodes:
            c.close()


def main(argv=None):  # pragma: no cover - CLI
    import argparse

    ap = argparse.ArgumentParser(
        description="Run one cross-host DRAM pool node (the redis_cluster "
        "node equivalent)."
    )
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7000,
                    help="0 = any free port (see --port-file)")
    ap.add_argument("--port-file",
                    help="write the port the node listens on to this file once "
                    "it accepts connections")
    ap.add_argument("--secret-env", default="HPS_CLUSTER_SECRET",
                    help="env var holding the shared auth secret "
                    "(unset/empty = no auth)")
    ap.add_argument("--tls-cert", help="PEM server certificate (enables TLS)")
    ap.add_argument("--tls-key", help="PEM server private key")
    args = ap.parse_args(argv)
    tls = None
    if args.tls_cert:
        tls = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        tls.load_cert_chain(args.tls_cert, args.tls_key)
    secret = os.environ.get(args.secret_env) or None
    srv = ClusterNodeServer(args.host, args.port, secret=secret,
                            tls=tls).start()
    log.info("cluster DRAM node serving on %s:%d", args.host, srv.port)
    if args.port_file:
        tmp = f"{args.port_file}.tmp"
        with open(tmp, "w") as f:
            f.write(f"{srv.port}\n")
        os.replace(tmp, args.port_file)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":  # pragma: no cover
    main()
