"""What the examples share: their command line, their scratch directory,
their checks and their HTTP requests."""

from __future__ import annotations

import argparse
import contextlib
import json
import tempfile
import urllib.request
from pathlib import Path


def check(ok, what: str) -> None:
    """An example's own check: raise naming ``what`` unless ``ok`` (not an
    ``assert``, which ``python -O`` drops)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


@contextlib.contextmanager
def workdir(root, prefix: str):
    """``root`` as a Path, or a temporary directory removed on exit."""
    if root is not None:
        Path(root).mkdir(parents=True, exist_ok=True)
        yield Path(root)
        return
    with tempfile.TemporaryDirectory(prefix=prefix) as d:
        yield Path(d)


def post_json(port: int, path: str, body: dict, timeout: float = 60.0) -> dict:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 json.dumps(body).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def keys_request(keys) -> dict:
    """A KServe-v2 JSON request of KEYS (INT64) and NUMKEYS (INT32)."""
    return {"inputs": [
        {"name": "KEYS", "datatype": "INT64", "shape": [len(keys)],
         "data": [int(k) for k in keys]},
        {"name": "NUMKEYS", "datatype": "INT32", "shape": [1], "data": [len(keys)]},
    ]}


def cli(main, doc: str, extra=None) -> None:
    """The examples' command line: ``--device`` (the card unless "cpu"),
    ``--root``, and ``extra(parser)``'s flags passed to ``main`` by name."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default=None, help="'cpu', or a card (default cuda:0)")
    ap.add_argument("--root", default=None, help="directory for the example's files")
    if extra is not None:
        extra(ap)
    args = vars(ap.parse_args())
    main(**args)
