"""An HPS model served by ps.json: KEYS (table-major) and NUMKEYS (one count
a table) in, OUTPUT0 (the rows, table-major, float32) out."""

from __future__ import annotations

import json
import os

import numpy as np

from hpsbench.deploy import binary_request

#: The control's precision: the reference's rows at int4 (the configuration's
#: is int8).
CONTROL = 4


def ps_model(cfg: dict, name: str, sparse_files, dims, per_sample) -> dict:
    n = len(sparse_files)
    return {
        "model": name, "sparse_files": sparse_files,
        "embedding_vecsize_per_table": dims,
        "maxnum_catfeature_query_per_table_per_sample": per_sample,
        "max_batch_size": cfg["max_batch_size"], "gpucacheper": cfg["gpucacheper"],
        "embedding_cache_type": cfg["embedding_cache_type"], "quant_bits": cfg["quant_bits"],
        "deployed_device_list": cfg["deployed_device_list"],
        "default_value_for_each_table": [cfg["default_value"]] * n,
        "num_of_worker_buffer_in_pool": cfg["num_of_worker_buffer_in_pool"],
        "max_queue_delay_us": cfg["max_queue_delay_us"],
    }


def write_table(path: str, keys: np.ndarray, vectors: np.ndarray) -> None:
    """The sparse-model format: ``key`` int64 and ``emb_vector`` float32,
    little-endian, row for row."""
    os.makedirs(path, exist_ok=True)
    np.ascontiguousarray(keys, "<i8").tofile(os.path.join(path, "key"))
    np.ascontiguousarray(vectors, "<f4").tofile(os.path.join(path, "emb_vector"))


def write(cfg, layout, vectors, work, seed) -> str:
    """The tables and ps.json; an HPS model draws nothing more from ``seed``."""
    files, off = [], 0
    for t, rows in enumerate(layout.rows):
        path = os.path.join(work, f"t{t}")
        write_table(path, layout.keys(t, np.arange(rows)), vectors[off: off + rows])
        files.append(path)
        off += rows
    n = len(files)
    hot = cfg["keys_per_table_per_sample"]
    ps = {"models": [ps_model(cfg, cfg["model"], files, [cfg["embedding_dim"]] * n,
                              hot if isinstance(hot, list) else [hot] * n)]}
    path = os.path.join(work, "ps.json")
    with open(path, "w") as f:
        json.dump(ps, f)
    return path


def serve(cfg, source, device):
    from hugectr_backend_tpu_torch.serving.server import serve as program_serve

    return program_serve(source, port=0, block=False, grpc_port=None, device=device)


def infer_path(cfg) -> str:
    return f"/v2/models/{cfg['model']}/infer"


def model_label(cfg) -> str:
    return cfg["model"]


def encode(cfg, req):
    keys = np.concatenate(req.keys)
    numkeys = np.asarray([k.size for k in req.keys], np.int32)
    return binary_request([("KEYS", "INT64", keys), ("NUMKEYS", "INT32", numkeys)], "OUTPUT0")


def judge(ctx, control=None) -> dict:
    """Every answered response against the reference, by digest of its raw
    float32 bytes (an exact comparison; the reference's answer to each
    distinct request is worked out once), and the largest gap over the
    responses kept whole. ``control`` 4: the reference's own rows at int4
    stand in for the program's answers."""
    from concurrent.futures import ThreadPoolExecutor

    from hpsbench.reference.hps import HpsReference

    dv = ctx.cfg["default_value"]
    ref = HpsReference(ctx.host_tables(), 8, dv)
    ctl = HpsReference(ctx.host_tables(), control, dv) if control else None
    res = ctx.results
    answered = np.flatnonzero(res.ok)
    kept = {int(res.entry[i]) for i in res.kept_rows()}

    def gap(got, want) -> float:
        if got.shape != want.shape:
            return float("inf")
        return float(np.abs(got - want).max()) if got.size else 0.0

    def expect(e):
        """-> (the reference's digest, the control's digest and gap, the
        reference's answer where a served one is kept whole)."""
        rows = ctx.requests[e].rows
        want = ref.response(rows)
        if ctl is None:
            return ctx.digest(want), None, 0.0, (want if e in kept else None)
        got = ctl.response(rows)
        return ctx.digest(want), ctx.digest(got), gap(got, want), None

    entries = np.unique(res.entry[answered]).tolist()
    with ThreadPoolExecutor(8) as ex:
        expected = dict(zip(entries, ex.map(expect, entries)))
    wrong, worst = 0, 0.0
    for i in answered:
        want_digest, ctl_digest, ctl_gap, want = expected[int(res.entry[i])]
        if ctl_digest is not None:
            wrong += want_digest != ctl_digest
            worst = max(worst, ctl_gap)
            continue
        wrong += want_digest != res.digest[i].tobytes()
        got = res.body(i)
        if got is not None:
            worst = max(worst, gap(got, want))
    lim = ctx.limits
    return {"wrong_answers": (int(wrong), lim["wrong_answers"]),
            "max_abs_gap": (worst, lim["max_abs_gap"])}


def warm_sizes(cfg, mix) -> list:
    """Every power-of-two bucket a merged batch of this traffic can take:
    from the smallest request up to the merge cap, the lesser of
    ``max_batch_size`` and the largest request times the callers (the
    batcher pads each table's run to a power of two)."""
    b = mix["samples_per_request"]
    lo, hi = (int(b), int(b)) if np.ndim(b) == 0 else (int(min(b)), int(max(b)))
    callers = int(mix.get("clients", mix.get("connections", 1)))
    top = min(int(cfg["max_batch_size"]), hi * callers)
    sizes, s = [lo], 1 << max(lo - 1, 0).bit_length()
    while s < 2 * top:
        size = min(s, top)
        if size not in sizes:
            sizes.append(size)
        s *= 2
    return sizes
