"""AUC-parity harness: does quantized serving preserve ranking quality?

Port of the JAX package's eval/auc_parity.py. It trains a DLRM jointly with
its embedding table on synthetic click data whose signal flows through the
embeddings, then scores a held-out set through the port's serving engine
(``HierParameterServer`` -> ``EmbeddingCache`` -> ``FusedDlrmServer`` or
``make_dlrm_multi_server``) under each lookup and dense flavour, and reports
each variant's AUC and its delta against fp32 serving. AUC is the metric
users of a CTR model care about; the gates live in the tests and in
``chip_smoke.py``.

The datasets and :func:`auc` are numpy only and copied as they are, so the
data is bit-identical to the JAX package's. Training is PyTorch:

- ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``, optax ``adam``'s
  formula, over the dense layers and the table;
- the table is ONE dense f32 parameter gathered as ``table[kidx]``: its
  gradient is dense, so the Adam moments of every row decay each step as
  under optax (no sparse embedding, no ``SparseAdam``);
- the loss is ``binary_cross_entropy_with_logits(...).mean()``;
- batches come from the same ``np.random.default_rng(seed).integers`` calls;
- the interaction runs on K4 (forward and backward kernels on the card);
- the initial state is Flax's distribution drawn from explicit generators
  (:meth:`DLRM.init_flax_`, table ``0.05 * N(0, 1)``), or a given
  ``(state_dict, table)`` (the parity tests start from the JAX init).

Entry points run on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
from hugectr_backend_tpu_torch.models.dlrm import DLRM
from hugectr_backend_tpu_torch.models.quant_dense import quantize_model_params
from hugectr_backend_tpu_torch.ops import kernels
from hugectr_backend_tpu_torch.ps.parameter_server import HierParameterServer
from hugectr_backend_tpu_torch.serving.program import FusedDlrmServer, make_dlrm_multi_server
from hugectr_backend_tpu_torch.tiers.hbm import default_device


@dataclasses.dataclass
class ClickDataset:
    key_ids: np.ndarray  # [vocab] int64 external key ids
    keys_idx: np.ndarray  # [N, F] int32 row index into the table
    dense: np.ndarray  # [N, num_dense] float32
    labels: np.ndarray  # [N] float32 in {0, 1}
    base_rate: float


def make_click_dataset(
    n_samples: int,
    vocab: int,
    num_feats: int = 26,
    num_dense: int = 13,
    seed: int = 0,
    noise: float = 1.0,
) -> ClickDataset:
    rng = np.random.default_rng(seed)
    # External ids: hashed-looking int64 keys, like a production id space.
    key_ids = np.sort(
        rng.choice(np.int64(1) << 40, size=vocab, replace=False).astype(
            np.int64
        )
    )
    a = rng.standard_normal(vocab).astype(np.float32)
    b = rng.standard_normal(vocab).astype(np.float32)
    w = rng.standard_normal(num_dense).astype(np.float32)
    # Zipf-ish feature popularity (hot keys dominate, as in CTR logs).
    pop = (1.0 / np.arange(1, vocab + 1) ** 0.8)
    pop /= pop.sum()
    keys_idx = rng.choice(vocab, size=(n_samples, num_feats), p=pop).astype(
        np.int32
    )
    dense = rng.standard_normal((n_samples, num_dense)).astype(np.float32)
    dot = dense @ w
    logit = (
        0.6 * a[keys_idx].sum(axis=1)
        + 0.25 * b[keys_idx].sum(axis=1) * dot
    )
    logit = (logit - logit.mean()) / (logit.std() + 1e-9) * 2.0
    p = 1.0 / (1.0 + np.exp(-(logit + noise * rng.standard_normal(n_samples))))
    labels = (rng.random(n_samples) < p).astype(np.float32)
    return ClickDataset(key_ids, keys_idx, dense, labels,
                        float(labels.mean()))


def auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Rank-based (Mann-Whitney U) AUC with tie handling."""
    labels = np.asarray(labels).astype(np.float64)
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = np.asarray(scores)[order]
    n = len(scores)
    i = 0
    while i < n:
        j = i
        while j + 1 < n and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    pos = labels.sum()
    neg = n - pos
    if pos == 0 or neg == 0:
        return float("nan")
    return float((ranks[labels == 1].sum() - pos * (pos + 1) / 2)
                 / (pos * neg))


@dataclasses.dataclass
class MultiClickDataset:
    key_ids: "list[np.ndarray]"  # per-table external int64 ids
    keys_idx: np.ndarray  # [N, F] int32 LOCAL row index into table f
    dense: np.ndarray
    labels: np.ndarray
    base_rate: float


def make_multi_click_dataset(
    n_samples: int,
    vocabs: "list[int]",
    num_dense: int = 13,
    seed: int = 0,
    noise: float = 1.0,
) -> MultiClickDataset:
    """Per-feature tables of different cardinalities (the Criteo shape);
    the click signal flows through every table's embeddings."""
    rng = np.random.default_rng(seed)
    key_ids, a_l, b_l, cols = [], [], [], []
    for v in vocabs:
        key_ids.append(np.sort(
            rng.choice(np.int64(1) << 40, size=v, replace=False).astype(
                np.int64)))
        a_l.append(rng.standard_normal(v).astype(np.float32))
        b_l.append(rng.standard_normal(v).astype(np.float32))
        pop = 1.0 / np.arange(1, v + 1) ** 0.8
        pop /= pop.sum()
        cols.append(rng.choice(v, size=n_samples, p=pop).astype(np.int32))
    keys_idx = np.stack(cols, axis=1)
    w = rng.standard_normal(num_dense).astype(np.float32)
    dense = rng.standard_normal((n_samples, num_dense)).astype(np.float32)
    dot = dense @ w
    a_term = sum(a_l[f][keys_idx[:, f]] for f in range(len(vocabs)))
    b_term = sum(b_l[f][keys_idx[:, f]] for f in range(len(vocabs)))
    logit = 0.6 * a_term + 0.25 * b_term * dot
    logit = (logit - logit.mean()) / (logit.std() + 1e-9) * 2.0
    p = 1.0 / (1.0 + np.exp(-(logit + noise * rng.standard_normal(n_samples))))
    labels = (rng.random(n_samples) < p).astype(np.float32)
    return MultiClickDataset(key_ids, keys_idx, dense, labels,
                             float(labels.mean()))


# ------------------------------------------------------------------ training


def dlrm_loss(model: DLRM, table: torch.Tensor, kidx: torch.Tensor,
              dense: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid cross-entropy of ``model`` on the rows ``table[kidx]``
    (``kidx`` [B, T] rows of the one table)."""
    logits = model(dense, table[kidx])
    return F.binary_cross_entropy_with_logits(logits, labels)


class DlrmTrainer:
    """Joint Adam training of a DLRM and one embedding table (a dense f32
    ``nn.Parameter``) on one device. ``offsets`` [T] (optional) maps each
    feature's local row index into the one table (the multi-table layout:
    the tables stacked, one row offset per feature)."""

    def __init__(self, model: DLRM, table: torch.Tensor, lr: float,
                 offsets: Optional[np.ndarray] = None):
        self.model = model
        self.device = table.device
        self.table = nn.Parameter(table)
        self.offsets = (None if offsets is None
                        else torch.as_tensor(offsets, dtype=torch.int64, device=self.device))
        self.opt = torch.optim.Adam([*model.parameters(), self.table], lr=lr,
                                    betas=(0.9, 0.999), eps=1e-8)

    def batch(self, data, sel: np.ndarray):
        """Rows ``sel`` of a (Multi)ClickDataset on the device:
        -> (kidx [B, T] int64 rows of the table, dense, labels)."""
        dev = self.device
        kidx = torch.from_numpy(data.keys_idx[sel]).to(dev).long()
        if self.offsets is not None:
            kidx = kidx + self.offsets
        return (kidx, torch.from_numpy(data.dense[sel]).to(dev),
                torch.from_numpy(data.labels[sel]).to(dev))

    def loss(self, kidx, dense, labels) -> torch.Tensor:
        return dlrm_loss(self.model, self.table, kidx, dense, labels)

    def step(self, kidx, dense, labels) -> torch.Tensor:
        """One Adam step. -> the loss before it (detached, not synchronised)."""
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss(kidx, dense, labels)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def fit(self, data, steps: int, batch: int, seed: int) -> np.ndarray:
        """``steps`` steps on batches drawn as the JAX package draws them.
        -> the loss of every step."""
        n = len(data.labels)
        rs = np.random.default_rng(seed)
        losses = [self.step(*self.batch(data, rs.integers(0, n, batch)))
                  for _ in range(steps)]
        out = torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32)
        if out.size and not np.isfinite(out[-1]):
            raise FloatingPointError(f"training diverged: last loss {out[-1]}")
        return out

    def table_numpy(self) -> np.ndarray:
        return self.table.detach().cpu().numpy()


def make_trainer(vocab_total: int, num_dense: int, num_feats: int, dim: int,
                 bottom_widths, top_widths, lr: float, seed: int, init=None,
                 offsets=None, device=None) -> DlrmTrainer:
    """A :class:`DlrmTrainer` for a fresh DLRM: Flax's initialisation drawn
    from ``torch.Generator().manual_seed(seed)`` and a table ``0.05 * N(0, 1)``
    from ``seed + 1``, or ``init = (state_dict, table)``."""
    dev = default_device(device)
    model = DLRM(num_dense, num_feats, (*bottom_widths, dim), top_widths)
    if init is None:
        model.init_flax_(torch.Generator().manual_seed(seed))
        table = 0.05 * torch.randn((vocab_total, dim),
                                   generator=torch.Generator().manual_seed(seed + 1))
    else:
        state, table = init
        model.load_state_dict(state)
        table = torch.tensor(np.asarray(table, np.float32))  # a copy: Adam updates it in place
    if tuple(table.shape) != (vocab_total, dim):
        raise ValueError(f"table must be [{vocab_total}, {dim}], got {tuple(table.shape)}")
    return DlrmTrainer(model.to(dev), table.to(dev), lr, offsets)


def train_dlrm(
    data: ClickDataset,
    dim: int = 16,
    steps: int = 400,
    batch: int = 512,
    lr: float = 5e-3,
    seed: int = 0,
    bottom_widths=(32,),
    top_widths=(64, 32, 1),
    init=None,
    device=None,
):
    """Joint Adam training of the dense graph AND the embedding table.

    -> (model, table [vocab, dim] f32 numpy, losses [steps]). The table is
    what serving quantizes; training it (rather than using synthetic
    vectors) is what makes the downstream AUC delta a real measurement."""
    trainer = make_trainer(len(data.key_ids), data.dense.shape[1], data.keys_idx.shape[1],
                           dim, bottom_widths, top_widths, lr, seed, init, device=device)
    losses = trainer.fit(data, steps, batch, seed)
    return trainer.model, trainer.table_numpy(), losses


def train_dlrm_multi(
    data: MultiClickDataset,
    dim: int = 16,
    steps: int = 400,
    batch: int = 512,
    lr: float = 5e-3,
    seed: int = 0,
    bottom_widths=(32,),
    top_widths=(64, 32, 1),
    init=None,
    device=None,
):
    """-> (model, tables: list of [vocab_f, dim] f32 numpy, losses). One
    table (a row offset per feature) keeps the train step a single gather;
    ``init``'s table is that stacked table."""
    vocabs = [len(k) for k in data.key_ids]
    offs = np.concatenate([[0], np.cumsum(vocabs)]).astype(np.int64)
    trainer = make_trainer(int(offs[-1]), data.dense.shape[1], data.keys_idx.shape[1],
                           dim, bottom_widths, top_widths, lr, seed, init,
                           offsets=offs[:-1], device=device)
    losses = trainer.fit(data, steps, batch, seed)
    table = trainer.table_numpy()
    return trainer.model, [table[offs[f]: offs[f + 1]] for f in range(len(vocabs))], losses


# ------------------------------------------------------------------- serving


def _serving_model(model: DLRM, dense_fmt: Optional[str]) -> DLRM:
    """``model`` itself, or for a dense flavour the same weights quantized
    (no retraining), as a deployment would convert them."""
    if not dense_fmt:
        return model
    qmodel = DLRM(model.num_dense, model.num_tables, model.bottom_widths,
                  model.top_widths, quant_fmt=dense_fmt)
    qmodel.load_state_dict(quantize_model_params(model.state_dict(), dense_fmt))
    return qmodel


def _scores(srv, n: int, batch: int, request) -> np.ndarray:
    return np.concatenate([
        srv.predict(*request(lo, min(lo + batch, n))).float().cpu().numpy()
        for lo in range(0, n, batch)
    ])


@contextlib.contextmanager
def _workdir(workdir: Optional[str], prefix: str):
    """``workdir`` as given (callers share one across variants: the files
    are written once), or a temporary directory removed afterwards."""
    if workdir is not None:
        yield workdir
        return
    with tempfile.TemporaryDirectory(prefix=prefix) as wd:
        yield wd


def _create_ps(workdir: str, dims, keys_per_sample, batch: int, quant_bits: int,
               fp8_quant: bool, device) -> HierParameterServer:
    """A parameter server over the tables ``workdir``/t0, t1, ... as the
    harness deploys them (static cache holding every row)."""
    return HierParameterServer.create({"models": [{
        "model": "dlrm",
        "sparse_files": [f"{workdir}/t{f}" for f in range(len(dims))],
        "embedding_vecsize_per_table": list(dims),
        "maxnum_catfeature_query_per_table_per_sample": list(keys_per_sample),
        "max_batch_size": batch,
        "gpucacheper": 1.0,
        "embedding_cache_type": "static",
        "quant_bits": quant_bits,
        "fp8_quant": fp8_quant,
    }]}, device=device)


def serving_scores(
    model: DLRM,
    key_ids: np.ndarray,
    table: np.ndarray,
    keys_idx: np.ndarray,
    dense: np.ndarray,
    quant_bits: int = 32,
    fp8_quant: bool = False,
    dense_fmt: Optional[str] = None,
    batch: int = 1024,
    workdir: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """Score held-out samples through the port's serving engine: the
    checkpoint written as a reference-format sparse model, a
    ``HierParameterServer`` with the requested ``quant_bits`` /
    ``fp8_quant``, and ``FusedDlrmServer`` (K1 + K4). A dense flavour
    (``dense_fmt``) quantizes the f32 weights with ``quantize_model_params``.
    ``workdir``: callers may share one across variants (the files are
    written once)."""
    num_feats = keys_idx.shape[1]
    with _workdir(workdir, "hps_auc_") as wd:
        if not os.path.exists(f"{wd}/t0"):
            write_sparse_model(f"{wd}/t0", key_ids, table)
        ps = _create_ps(wd, [table.shape[1]], [num_feats], batch, quant_bits,
                        fp8_quant, device)
    srv = FusedDlrmServer(ps.get_model_params("dlrm"), ps.get_embedding_cache("dlrm", 0),
                          _serving_model(model, dense_fmt))
    qkeys = key_ids[keys_idx]  # external ids, the engine translates
    return _scores(srv, len(qkeys), batch, lambda lo, hi: (qkeys[lo:hi], dense[lo:hi]))


#: name -> (quant_bits, fp8_quant, dense_fmt) per serving variant.
VARIANTS = {
    "fp32": (32, False, None),
    "int8": (8, False, None),
    "int4": (4, False, None),
    "fp8": (8, True, None),
    "int8+dense_int8": (8, False, "int8"),
    # fp8_quant overrides quant_bits (config/params.py): this row is int8
    # lookups composed with fp8 dense layers.
    "int8+dense_fp8": (8, False, "fp8"),
    "int8+dense_w8a8": (8, False, "w8a8"),
}


def run_parity(
    n_train: int = 80_000,
    n_eval: int = 20_000,
    vocab: int = 3_000,
    dim: int = 16,
    num_feats: int = 26,
    steps: int = 400,
    seed: int = 0,
    variants=None,
    device=None,
) -> dict:
    """Train once, serve every variant, report AUCs + deltas vs fp32."""
    data = make_click_dataset(n_train + n_eval, vocab, num_feats=num_feats, seed=seed)
    train = ClickDataset(data.key_ids, data.keys_idx[:n_train], data.dense[:n_train],
                         data.labels[:n_train], data.base_rate)
    model, table, losses = train_dlrm(train, dim=dim, steps=steps, seed=seed, device=device)
    kidx = data.keys_idx[n_train:]
    dense = data.dense[n_train:]
    labels = data.labels[n_train:]
    out = {
        "n_train": n_train, "n_eval": n_eval, "vocab": vocab, "dim": dim,
        "num_feats": num_feats, "steps": steps, "base_rate": data.base_rate,
        "final_loss": float(losses[-1]) if len(losses) else None,
        "auc": {}, "delta_vs_fp32": {},
    }
    with tempfile.TemporaryDirectory(prefix="hps_auc_") as wd:
        for name in variants or VARIANTS:
            qb, fp8, dfmt = VARIANTS[name]
            scores = serving_scores(model, data.key_ids, table, kidx, dense, quant_bits=qb,
                                    fp8_quant=fp8, dense_fmt=dfmt, workdir=wd, device=device)
            out["auc"][name] = auc(labels, scores)
    base = out["auc"].get("fp32")
    if base is not None:
        for name, a in out["auc"].items():
            out["delta_vs_fp32"][name] = a - base
    return out


# ---------------------------------------------------------------- path parity
#
# The multi-table harness trains one checkpoint over F tables and serves it
# through make_dlrm_multi_server (the chunked fused program production uses,
# fold included), with the grouping thresholds scaled through their
# environment variables so that every lookup kind appears at harness size.


def multi_serving_scores(
    model: DLRM,
    key_ids: "list[np.ndarray]",
    tables: "list[np.ndarray]",
    keys_idx: np.ndarray,
    dense: np.ndarray,
    quant_bits: int = 32,
    env: "Optional[dict]" = None,
    batch: int = 1024,
    workdir: Optional[str] = None,
    dense_fmt: Optional[str] = None,
    device=None,
) -> np.ndarray:
    """Score through make_dlrm_multi_server: mixed one-hot / arena / solo
    groups, part-major reorder, the one-hot fold (K1 + K3, or K1 + K2 with
    ``HPS_OH_IN_KERNEL=0``). ``env`` temporarily overrides path knobs
    (grouping thresholds, ``HPS_OH_IN_KERNEL``) for the build AND the
    serving calls; ``dense_fmt`` serves the weights quantized (w8a8 runs
    K5), which the JAX package's function does not offer."""
    nf = keys_idx.shape[1]
    dim = tables[0].shape[1]
    saved = {}
    try:
        for k, v in (env or {}).items():
            saved[k] = os.environ.get(k)
            os.environ[k] = str(v)
        with _workdir(workdir, "hps_auc_multi_") as wd:
            for f in range(nf):
                if not os.path.exists(f"{wd}/t{f}"):
                    write_sparse_model(f"{wd}/t{f}", key_ids[f], tables[f])
            ps = _create_ps(wd, [dim] * nf, [1] * nf, batch, quant_bits, False, device)
        srv = make_dlrm_multi_server(ps.get_model_params("dlrm"),
                                     ps.get_embedding_cache("dlrm", 0),
                                     _serving_model(model, dense_fmt))

        def request(lo, hi):
            kidx = keys_idx[lo:hi]
            return ([key_ids[f][kidx[:, f]].reshape(-1, 1) for f in range(nf)],
                    dense[lo:hi])

        return _scores(srv, len(keys_idx), batch, request)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_path_parity(
    n_train: int = 60_000,
    n_eval: int = 20_000,
    vocabs: "Optional[list[int]]" = None,
    dim: int = 32,
    steps: int = 300,
    seed: int = 0,
    thresholds: "Optional[dict]" = None,
    device=None,
) -> dict:
    """Per-PATH AUC deltas through the serving program of the port.

    Legs: fp32 (the fold: K1 + K3 on an f32 arena); ``int8_mixed_policy``
    through the mixed one-hot / arena / solo grouping (thresholds scaled by
    ``thresholds``) with the fold off (``HPS_OH_IN_KERNEL=0``: the one-hot
    group looked up by K1, the interaction on K2); ``int4_mixed_policy``;
    and ``int8_oh_fold``, the one-hot group folded into the interaction
    (K3), which stands for the JAX package's ``int8_oh_kernel_interpret``
    leg: ``oh_kernel_engaged`` says that K3 ran (its launch count on the
    card, a spy on the wrapper on the CPU), and it is scored on the whole
    eval set. The JAX package's ``int8_blocked_layout`` leg has no
    counterpart: the port stores every table flat ``[R, D]`` (the blocked
    layout is a TPU compiler workaround, ROADMAP "Layouts not carried
    over")."""
    import hugectr_backend_tpu_torch.models.dlrm as dlrm_mod

    vocabs = vocabs or [60, 90, 300, 420, 1500, 2200, 3000, 5000]
    # Scale the grouping policy to harness size: tiny -> one-hot, medium ->
    # shared arena, large -> solo (production: 4k / 64k).
    thresholds = thresholds or {
        "HPS_TPU_ONEHOT_MAX_ROWS": 512,
        "HPS_TPU_ARENA_MEMBER_MAX_ROWS": 2048,
    }
    dev = default_device(device)
    data = make_multi_click_dataset(n_train + n_eval, vocabs, seed=seed)
    train = MultiClickDataset(data.key_ids, data.keys_idx[:n_train], data.dense[:n_train],
                              data.labels[:n_train], data.base_rate)
    model, tables, _ = train_dlrm_multi(train, dim=dim, steps=steps, seed=seed, device=dev)
    kidx = data.keys_idx[n_train:]
    dense = data.dense[n_train:]
    labels = data.labels[n_train:]

    def score(quant, extra_env=None):
        env = dict(thresholds)
        env.update(extra_env or {})
        return multi_serving_scores(model, data.key_ids, tables, kidx, dense,
                                    quant_bits=quant, env=env, workdir=shared_wd, device=dev)

    out = {
        "vocabs": vocabs, "dim": dim, "num_feats": len(vocabs),
        "n_train": n_train, "n_eval": n_eval, "steps": steps,
        "thresholds": thresholds, "auc": {}, "delta_vs_fp32": {},
    }
    with tempfile.TemporaryDirectory(prefix="hps_auc_path_") as shared_wd:
        out["auc"]["fp32"] = base = auc(labels, score(32))
        for name, quant, extra in (
            ("int8_mixed_policy", 8, {"HPS_OH_IN_KERNEL": "0"}),
            ("int4_mixed_policy", 4, None),
            ("int8_oh_fold", 8, None),
        ):
            if name == "int8_oh_fold":
                calls = {"n": 0}
                real = dlrm_mod.dot_interaction_oh_parts

                def spy(*a):
                    calls["n"] += 1
                    return real(*a)

                launched = kernels.launches["dot_interaction_oh_parts"]
                dlrm_mod.dot_interaction_oh_parts = spy
                try:
                    s = score(quant, extra)
                finally:
                    dlrm_mod.dot_interaction_oh_parts = real
                if dev.type == "cuda":
                    out["oh_kernel_engaged"] = kernels.launches["dot_interaction_oh_parts"] > launched
                else:
                    out["oh_kernel_engaged"] = calls["n"] > 0
            else:
                s = score(quant, extra)
            out["auc"][name] = a = auc(labels, s)
            out["delta_vs_fp32"][name] = a - base
    return out
