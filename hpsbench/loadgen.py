"""The load generator: a process of its own, so that its clients never hold
the server's interpreter lock. It imports numpy and the standard library
only.

    python3 -m hpsbench.loadgen <plan.json>

The plan (written by ``hpsbench.run``) names the request bodies, the port and
path, and the loop:

- open: a dispatcher thread hands send i (request ``order[i]``) to a pool
  of ``connections`` keep-alive connections at ``t0 + sched[i]``, whatever
  came back before; a
  request's latency runs from that due time, so a stall counts against every
  request it delays, and ``sent - due`` is the generator's own lateness;
- closed: ``clients`` threads, each on its own connection, send the pool
  entries of ``order`` in turn, a request as soon as the last is answered
  (its due time is its send time), until ``t0 + seconds``.

The traffic starts ``warm_s`` seconds before the window's ``t0`` (the open
loop's warm-up requests have negative ``sched``); the harness drops every
request due before ``t0``. Protocol on stdin / stdout: prints ``ready`` once
the bodies are loaded and the connections open, waits for ``go <start>``
(on CLOCK_MONOTONIC, the clock of ``time.monotonic`` in every process;
``t0 = start + warm_s``), prints ``done`` once the results are written.
Each answer's output tensor is kept as a 16-byte digest of its raw bytes
(``digest``), and whole where the plan says so (the first answer in the
window to each request the plan keeps).

A request is done at its answer's last byte. The digests are worked out by
threads of their own, one a connection, so that a caller sends its next
request while its last answer is hashed (an answer of tens of MB takes tens
of ms); a caller waits for them only when as many answers as there are
hashers are already queued, and the time callers spend so is written out
(``digest_wait_s``): where it is not near 0, the generator holds the loop
back. It also writes out the cores it held from the start of its traffic to
its end (``cores``).
"""

from __future__ import annotations

import hashlib
import http.client
import json
import os
import queue
import sys
import threading
import time

import numpy as np

TIMEOUT_S = 120.0


def digest(raw) -> bytes:
    """An answer's 16-byte digest: SHA-256 of its raw bytes, truncated (about
    1.3 GB/s on a CPU with SHA extensions, where BLAKE2b hashes 0.5)."""
    return hashlib.sha256(raw).digest()[:16]


class Client:
    def __init__(self, plan: dict):
        self.plan = plan
        with open(plan["bodies"], "rb") as f:
            self.blob = memoryview(f.read())
        arr = np.load(plan["arrays"])
        self.offsets = arr["offsets"]
        self.hdr_len = arr["hdr_len"]
        self.sched = arr["sched"]
        self.order = arr["order"]
        self.keep = arr["keep"]
        self.headers = [{"Inference-Header-Content-Length": str(int(h)),
                         "Content-Type": "application/octet-stream"} for h in self.hdr_len]
        self.lock = threading.Lock()
        self.rows = []  # [entry, due, sent, done, status, digest]
        self.kept = {}  # row index -> output bytes
        self.kept_entries = set()  # entries whose first answer is kept
        self.errors = []
        self.t0 = float("inf")  # the window's open, once ``go`` has come
        n = int(plan["connections"])
        self.hash_q: "queue.Queue" = queue.Queue(maxsize=n)
        self.hashers = [threading.Thread(target=self.hash_answers, daemon=True)
                        for _ in range(n)]
        self.digest_wait_s = 0.0

    def hash_answers(self):
        while True:
            item = self.hash_q.get()
            if item is None:
                return
            row, out = item
            dig = digest(out)
            with self.lock:
                self.rows[row][5] = dig

    def connect(self):
        c = http.client.HTTPConnection("127.0.0.1", self.plan["port"], timeout=TIMEOUT_S)
        c.connect()
        return c

    def send(self, conn, entry: int, due: float):
        """One request on ``conn``. -> the connection to use next (a new
        one after a transport error)."""
        body = self.blob[self.offsets[entry]: self.offsets[entry + 1]]
        sent = time.monotonic()
        status, out = -1, None
        try:
            conn.request("POST", self.plan["path"], body=body, headers=self.headers[entry])
            resp = conn.getresponse()
            data = resp.read()
            status = resp.status
            if status == 200:
                h = int(resp.getheader("Inference-Header-Content-Length"))
                out = memoryview(data)[h:]
        except (OSError, http.client.HTTPException, ValueError, TypeError) as e:
            with self.lock:
                self.errors.append(repr(e))
            conn.close()
            conn = self.connect()
            out = None
        done = time.monotonic()
        with self.lock:
            row = len(self.rows)
            self.rows.append([entry, due, sent, done, status, b""])
            if out is not None and self.keep[entry] and due >= self.t0 and (
                    self.plan["keep_every_answer"] or entry not in self.kept_entries):
                self.kept_entries.add(entry)
                self.kept[row] = bytes(out)
        if out is not None:
            t = time.monotonic()
            self.hash_q.put((row, out))
            waited = time.monotonic() - t
            with self.lock:
                self.digest_wait_s += waited
        return conn

    def run_open(self, t0: float, conns):
        q: "queue.SimpleQueue" = queue.SimpleQueue()

        def worker(conn):
            while True:
                i = q.get()
                if i is None:
                    conn.close()
                    return
                conn = self.send(conn, int(self.order[i]), t0 + self.sched[i])

        threads = [threading.Thread(target=worker, args=(c,), daemon=True) for c in conns]
        for th in threads:
            th.start()
        for i in range(self.sched.size):
            delay = t0 + self.sched[i] - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            q.put(i)
        for _ in threads:
            q.put(None)
        return threads

    def run_closed(self, t0: float, conns):
        end = t0 + float(self.plan["seconds"])
        nxt = iter(range(self.order.size))

        def client(conn):
            while True:
                now = time.monotonic()
                if now >= end:
                    conn.close()
                    return
                with self.lock:
                    k = next(nxt, None)
                if k is None:
                    conn.close()
                    return
                conn = self.send(conn, int(self.order[k]), now)

        threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in conns]
        for th in threads:
            th.start()
        return threads

    def main(self):
        conns = [self.connect() for _ in range(int(self.plan["connections"]))]
        for th in self.hashers:
            th.start()
        print("ready", flush=True)
        line = sys.stdin.readline().split()
        if len(line) != 2 or line[0] != "go":
            raise SystemExit(f"expected 'go <start>', got {line!r}")
        start = float(line[1])
        t0 = self.t0 = start + float(self.plan["warm_s"])
        delay = start - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        cpu0, wall0 = os.times(), time.monotonic()
        if self.plan["loop"] == "open":
            threads = self.run_open(t0, conns)
        else:
            threads = self.run_closed(t0, conns)
        for th in threads:
            th.join(TIMEOUT_S + float(self.plan["seconds"]))
        alive = sum(th.is_alive() for th in threads)
        for _ in self.hashers:
            self.hash_q.put(None)
        for th in self.hashers:
            th.join()
        cpu1 = os.times()
        cores = (cpu1.user + cpu1.system - cpu0.user - cpu0.system) / (time.monotonic() - wall0)
        rows = list(self.rows)
        kept = sorted(self.kept.items())
        np.savez(self.plan["results"],
                 entry=np.asarray([r[0] for r in rows], np.int64),
                 due=np.asarray([r[1] for r in rows], np.float64),
                 sent=np.asarray([r[2] for r in rows], np.float64),
                 done=np.asarray([r[3] for r in rows], np.float64),
                 status=np.asarray([r[4] for r in rows], np.int32),
                 digest=np.frombuffer(b"".join(r[5] or b"\0" * 16 for r in rows),
                                      np.uint8).reshape(-1, 16),
                 kept_idx=np.asarray([k for k, _ in kept], np.int64),
                 kept_len=np.asarray([len(b) for _, b in kept], np.int64),
                 kept_blob=np.frombuffer(b"".join(b for _, b in kept), np.uint8),
                 errors=np.asarray(self.errors[:20] + ([f"{alive} client threads did not end"]
                                                       if alive else []), str),
                 t0=t0, digest_wait_s=self.digest_wait_s, cores=cores)
        print("done", flush=True)


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        Client(json.load(f)).main()
