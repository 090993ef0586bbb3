"""MLPerf DLRM served whole behind the program's KServe ensemble: a model
repository of an HPS model (the configuration's tables), a DLRM dense model
(``hps_tpu_dlrm_v1``: weights drawn from the seed) and the ensemble chaining
them, served by ``serve(model_repository=...)``.

The ensemble takes ``KEYS`` (INT64, table-major), ``NUMKEYS`` (INT32, one
count a table) and ``DENSE`` (FP32, [samples, num_dense]) and answers
``LOGITS`` (FP32, [samples, 1]). The weights are Flax's initialisation
(``lecun_normal`` kernels: a normal truncated at +-2 of its std, variance 1
/ fan_in; zero biases), drawn from stream (6, 1) of the seed by ``weights``,
which the judge calls again with ``ctx.seed``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from hpsbench import tables
from hpsbench.deploy import hps

#: The control's precision: every MLP layer's operands in bf16 (the
#: configuration's are f32).
CONTROL = "bf16"
#: The std of a unit normal truncated at +-2 (Flax's ``lecun_normal``).
TRUNC_STD = 0.87962566103423978
#: The program's smallest bucket (its batches are padded to powers of two).
MIN_BUCKET = 8

HPS_PBTXT = """name: "{name}"
backend: "hps"
max_batch_size: {max_batch_size}
input [
  {{ name: "KEYS" data_type: TYPE_INT64 dims: [ -1 ] }},
  {{ name: "NUMKEYS" data_type: TYPE_INT32 dims: [ -1 ] }}
]
output [ {{ name: "OUTPUT0" data_type: TYPE_FP32 dims: [ -1 ] }} ]
instance_group [ {{ count: 1 kind: KIND_GPU gpus: [ 0 ] }} ]
"""

DENSE_PBTXT = """name: "{name}"
platform: "hps_tpu_dense"
max_batch_size: 0
input [
  {{ name: "dense_features" data_type: TYPE_FP32 dims: [ -1, {num_dense} ] }},
  {{ name: "embeddings" data_type: TYPE_FP32 dims: [ -1 ] }}
]
output [ {{ name: "logits" data_type: TYPE_FP32 dims: [ -1, 1 ] }} ]
"""

ENSEMBLE_PBTXT = """name: "{name}"
platform: "ensemble"
max_batch_size: 0
input [
  {{ name: "KEYS" data_type: TYPE_INT64 dims: [ -1 ] }},
  {{ name: "NUMKEYS" data_type: TYPE_INT32 dims: [ -1 ] }},
  {{ name: "DENSE" data_type: TYPE_FP32 dims: [ -1, {num_dense} ] }}
]
output [ {{ name: "LOGITS" data_type: TYPE_FP32 dims: [ -1, 1 ] }} ]
ensemble_scheduling {{
  step [
    {{
      model_name: "{hps}"
      model_version: -1
      input_map {{ key: "KEYS" value: "KEYS" }}
      input_map {{ key: "NUMKEYS" value: "NUMKEYS" }}
      output_map {{ key: "OUTPUT0" value: "EMBEDDINGS" }}
    }},
    {{
      model_name: "{dense}"
      model_version: -1
      input_map {{ key: "dense_features" value: "DENSE" }}
      input_map {{ key: "embeddings" value: "EMBEDDINGS" }}
      output_map {{ key: "logits" value: "LOGITS" }}
    }}
  ]
}}
"""


def widths(cfg: dict) -> tuple:
    """-> (bottom, top): each MLP's widths from its input to its output."""
    feats = len(cfg["rows_per_table"]) + 1
    dim = cfg["embedding_dim"]
    return ([cfg["num_dense"], *cfg["bottom_mlp"]],
            [dim + feats * (feats - 1) // 2, *cfg["top_mlp"]])


def weights(cfg: dict, seed: int) -> tuple:
    """-> (bottom, top): [(w [in, out], b [out])] float32, Flax's init drawn
    from stream (6, 1) of the seed, layer by layer, bottom first."""
    rng = tables.stream(seed, 6, 1)

    def layer(a: int, b: int):
        z = rng.standard_normal((a, b))
        out = np.abs(z) > 2
        while out.any():
            z[out] = rng.standard_normal(int(out.sum()))
            out = np.abs(z) > 2
        std = (1.0 / a) ** 0.5 / TRUNC_STD
        return (z * std).astype(np.float32), np.zeros(b, np.float32)

    return tuple([layer(a, b) for a, b in zip(w, w[1:])] for w in widths(cfg))


def write(cfg, layout, vectors, work, seed) -> str:
    """The model repository: ps.json and the HPS model's directory (its
    tables under ``work``), the DLRM's directory and the ensemble's."""
    repo = os.path.join(work, "repo")
    files, off = [], 0
    for t, rows in enumerate(layout.rows):
        path = os.path.join(work, f"t{t}")
        hps.write_table(path, layout.keys(t, np.arange(rows)), vectors[off: off + rows])
        files.append(path)
        off += rows
    n = len(files)
    names = {"hps": cfg["hps_model"], "dense": cfg["dense_model"], "ens": cfg["model"]}
    for key in names.values():
        os.makedirs(os.path.join(repo, key, "1"))
    with open(os.path.join(repo, "ps.json"), "w") as f:
        json.dump({"models": [hps.ps_model(cfg, names["hps"], files,
                                           [cfg["embedding_dim"]] * n, [1] * n)]}, f)
    texts = {names["hps"]: HPS_PBTXT.format(name=names["hps"],
                                            max_batch_size=cfg["max_batch_size"]),
             names["dense"]: DENSE_PBTXT.format(name=names["dense"],
                                                num_dense=cfg["num_dense"]),
             names["ens"]: ENSEMBLE_PBTXT.format(name=names["ens"], num_dense=cfg["num_dense"],
                                                 **names)}
    for key, text in texts.items():
        with open(os.path.join(repo, key, "config.pbtxt"), "w") as f:
            f.write(text)
    bottom, top = weights(cfg, seed)
    bw, tw = widths(cfg)
    vdir = os.path.join(repo, names["dense"], "1")
    spec = {"format": "hps_tpu_dlrm_v1", "num_dense": cfg["num_dense"], "num_tables": n,
            "dim": cfg["embedding_dim"], "bottom": bw, "top": tw,
            "interaction": cfg["interaction"]}
    with open(os.path.join(vdir, "dense_model.json"), "w") as f:
        json.dump(spec, f)
    arrays = {f"{k}.{i}.{p}": a for k, layers in (("bottom", bottom), ("top", top))
              for i, layer in enumerate(layers) for p, a in zip("wb", layer)}
    np.savez(os.path.join(vdir, "dense_model.npz"), **arrays)
    return repo


def serve(cfg, source, device):
    from hugectr_backend_tpu_torch.serving.server import serve as program_serve

    return program_serve(model_repository=source, port=0, block=False, grpc_port=None,
                         device=device)


def infer_path(cfg) -> str:
    return f"/v2/models/{cfg['model']}/infer"


def model_label(cfg) -> str:
    return cfg["model"]


def encode(cfg, req):
    """KEYS (INT64, table-major), NUMKEYS (INT32, one a table) and DENSE
    (FP32, [samples, num_dense]), asking for LOGITS in binary."""
    raws = [np.ascontiguousarray(np.concatenate(req.keys), "<i8"),
            np.asarray([k.size for k in req.keys], "<i4"),
            np.ascontiguousarray(req.dense, "<f4")]
    shapes = [[int(raws[0].size)], [int(raws[1].size)], [req.samples, cfg["num_dense"]]]
    hdr = json.dumps({"inputs": [
        {"name": n, "datatype": dt, "shape": shape,
         "parameters": {"binary_data_size": int(r.nbytes)}}
        for n, dt, shape, r in zip(("KEYS", "NUMKEYS", "DENSE"), ("INT64", "INT32", "FP32"),
                                   shapes, raws)],
        "outputs": [{"name": "LOGITS", "parameters": {"binary_data": True}}]}).encode()
    return hdr, b"".join(r.tobytes() for r in raws)


def warm_sizes(cfg, mix) -> list:
    """One request of each bucket the traffic's sizes fall in, and of each
    bucket between them: the fused path pads a request to a power of two
    (at least 8), the shape every kernel of its device program takes."""
    b = mix["samples_per_request"]
    sizes = [int(b)] if np.ndim(b) == 0 else [int(s) for s in b]

    def bucket(n: int) -> int:
        s = MIN_BUCKET
        while s < n:
            s *= 2
        return s

    out, s = [], bucket(min(sizes))
    while s <= bucket(max(sizes)):
        out.append(s)
        s *= 2
    return out


def judge(ctx, control=None) -> dict:
    """Every answered logit against the reference's, worked out once for
    each distinct request, on ``ctx.device``, in blocks. A logit is wrong
    where it lies further from the reference than the ``max_abs_gap``
    limit, or is not finite; an answer of the wrong size is wrong in every
    logit. ``max_rel_gap``: an answer's largest gap over its largest
    reference logit. An answer whose body was not kept is judged by its
    digest where it equals that of a judged answer to the same request, and
    is otherwise counted in ``unjudged_answers`` (none where the mix keeps
    every body). ``median_abs_gap``: the median gap of the logits of the
    answers judged by their bodies, which a precision lost in every logit
    (such as TF32 in the MLPs) moves and the rare bf16 roundings of z that
    fall the other way do not. ``control`` "bf16": the reference with bf16
    MLP operands stands in for every answer."""
    from hpsbench.reference.dlrm_ensemble import DlrmReference

    cfg, res, lim = ctx.cfg, ctx.results, ctx.limits
    bottom, top = weights(cfg, ctx.seed)
    ref = DlrmReference(ctx.host_tables(), bottom, top, cfg["default_value"], ctx.device)
    answered = np.flatnonzero(res.ok)
    entries = np.unique(res.entry[answered]).tolist()
    reqs = [ctx.requests[e] for e in entries]
    want = dict(zip(entries, ref.requests(reqs)))
    stand_in = None
    if control is not None:
        if control != CONTROL:
            raise ValueError(f"control {control!r}: this kind's control is {CONTROL!r}")
        stand_in = dict(zip(entries, ref.control().requests(reqs)))

    def verdict(got, w) -> tuple:
        """-> (wrong logits, the largest gap, the largest relative gap, the
        gap of each logit)."""
        if got.shape != w.shape:
            return w.size, float("inf"), float("inf"), np.full(w.size, np.inf)
        gap = np.abs(got.astype(np.float64) - w)
        bad = ~np.isfinite(gap) | (gap > lim["max_abs_gap"])
        worst = float(gap.max()) if gap.size else 0.0
        return int(bad.sum()), worst, worst / max(float(np.abs(w).max()), 1e-30), gap

    wrong, abs_gap, rel_gap, unjudged = 0, 0.0, 0.0, 0
    judged = {}  # (entry, digest) -> verdict
    later, gaps = [], []
    for i in answered:
        e = int(res.entry[i])
        got = stand_in[e] if stand_in is not None else res.body(i)
        if got is None:
            later.append(i)
            continue
        v = verdict(got, want[e])
        judged.setdefault((e, res.digest[i].tobytes()), v)
        wrong += v[0]
        abs_gap, rel_gap = max(abs_gap, v[1]), max(rel_gap, v[2])
        gaps.append(v[3])
    for i in later:
        v = judged.get((int(res.entry[i]), res.digest[i].tobytes()))
        if v is None:
            unjudged += 1
        else:
            wrong += v[0]
    return {"wrong_answers": (int(wrong), lim["wrong_answers"]),
            "max_abs_gap": (abs_gap, lim["max_abs_gap"]),
            "max_rel_gap": (rel_gap, lim["max_rel_gap"]),
            "median_abs_gap": (float(np.median(np.concatenate(gaps))) if gaps else 0.0,
                               lim["median_abs_gap"]),
            "unjudged_answers": (int(unjudged), None)}
