"""The load generator under stress: many callers, answers of several sizes
and a short switch interval, and every answer's digest, worked out on the
hasher threads, lands on its own row."""

import http.server
import io
import json
import sys
import threading
import time

import numpy as np

from hpsbench import loadgen


class _Echo(http.server.BaseHTTPRequestHandler):
    """Answers a request with an empty header and its body repeated 1-4
    times, so that each request has an answer of its own."""

    protocol_version = "HTTP/1.1"

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        out = body * (1 + body[0] % 4)
        self.send_response(200)
        self.send_header("Inference-Header-Content-Length", "2")
        self.send_header("Content-Length", str(2 + len(out)))
        self.end_headers()
        self.wfile.write(b"{}" + out)

    def log_message(self, *args):
        pass


def test_every_digest_lands_on_its_row(tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    bodies = [rng.bytes(int(n)) for n in rng.integers(1, 200_000, 24)]
    offsets = np.concatenate([[0], np.cumsum([len(b) for b in bodies])])
    (tmp_path / "bodies.bin").write_bytes(b"".join(bodies))
    np.savez(tmp_path / "arrays.npz", offsets=offsets, hdr_len=np.zeros(24, np.int64),
             sched=np.zeros(0), order=np.arange(24_000) % 24, keep=np.zeros(24, bool))
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Echo)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    plan = {"bodies": str(tmp_path / "bodies.bin"), "arrays": str(tmp_path / "arrays.npz"),
            "results": str(tmp_path / "results.npz"), "port": server.server_address[1],
            "path": "/", "loop": "closed", "connections": 16, "seconds": 1.0,
            "keep_every_answer": False, "warm_s": 0.0}
    monkeypatch.setattr(sys, "stdin", io.StringIO(f"go {time.monotonic() + 2.0!r}\n"))
    monkeypatch.setattr(sys, "stdout", io.StringIO())
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        loadgen.Client(json.loads(json.dumps(plan))).main()
    finally:
        sys.setswitchinterval(interval)
        server.shutdown()
        server.server_close()
    with np.load(tmp_path / "results.npz") as z:
        entry, status, digests, errors = z["entry"], z["status"], z["digest"], z["errors"]
        assert float(z["cores"]) > 0 and float(z["digest_wait_s"]) >= 0
    assert entry.size > 16 and (status == 200).all(), errors
    for e, d in zip(entry, digests):
        b = bodies[e]
        assert d.tobytes() == loadgen.digest(b * (1 + b[0] % 4))
