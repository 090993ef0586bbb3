"""How each kind of configuration is written to disk, served and judged.

``deploy/<kind>.py`` (the configuration's ``kind``) gives:

- ``write(cfg, layout, vectors, work, seed) -> source``: the model files
  under ``work`` in the formats the program loads (raw ``key`` /
  ``emb_vector`` files, a ps.json, a dense model's weights); a kind draws
  what it adds to the tables (its weights) from ``seed``, on stream (6, j)
  (``tables.stream``);
- ``serve(cfg, source, device)``: the program's KServe-v2 HTTP server on
  port 0, in this process;
- ``infer_path(cfg)``, ``model_label(cfg)``: the endpoint, and the ``model``
  label of the program's histograms;
- ``encode(cfg, request) -> (header, raw)``: one request in the
  binary-tensor form, from its keys (``request.keys``, one array a table,
  multi-hot bags sample-major) and, where the configuration has
  ``num_dense``, its dense features (``request.dense``);
- ``warm_sizes(cfg, mix) -> [samples]``: one request of each size is sent
  before the window, so that no shape the traffic makes is new inside it;
- ``judge(ctx, control=None) -> {name: (value, limit)}``: the served
  answers against the plain reference (``reference/<kind>.py``), which
  works out again from ``ctx.seed`` whatever ``write`` drew and reads
  ``ctx.requests`` (keys, rows, ``dense``); ``control`` puts the reference
  at the precision below the configuration's in the program's place;
- ``CONTROL``: that precision, as ``judge`` takes it.

A new kind is new files only: ``deploy/<kind>.py``, ``reference/<kind>.py``,
``configs/<config>.json`` (``kind``, sizes, ``keys_per_table_per_sample`` as
a count or one a table, ``num_dense``), ``limits/<config>.json``,
``traffic/<traffic>.json`` (``samples_per_request`` as a size or a list),
``metrics/<metric>.py`` readers, and their entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib
import json

import numpy as np


def kind(cfg: dict):
    return importlib.import_module(f"hpsbench.deploy.{cfg['kind']}")


def binary_request(tensors, output: str) -> bytes:
    """A KServe-v2 binary-tensor request: ``tensors`` = [(name, datatype,
    array)], asking for ``output`` in binary. -> the JSON header's bytes
    followed by the raw tensors; the header's length goes in the
    Inference-Header-Content-Length header."""
    raws = [np.ascontiguousarray(a, {"INT64": "<i8", "INT32": "<i4"}[dt]) for _, dt, a in tensors]
    hdr = json.dumps({"inputs": [
        {"name": n, "datatype": dt, "shape": [int(r.size)],
         "parameters": {"binary_data_size": int(r.nbytes)}}
        for (n, dt, _), r in zip(tensors, raws)],
        "outputs": [{"name": output, "parameters": {"binary_data": True}}]}).encode()
    return hdr, b"".join(r.tobytes() for r in raws)
