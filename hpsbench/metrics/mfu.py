"""The fused DLRM path's model FLOPs: those of the samples answered in the
profiled slice over the slice's wall seconds at the card's f32 peak
(``peaks.json`` ``f32_flops_per_s``; the MLPs run in f32, TF32 off), %.

A sample's FLOPs: 2 per multiply-add of every MLP layer and 2 x dim per
pair of the interaction's F(F-1)/2 (F = tables + 1); biases, ReLUs, the
gathers and the pads are not counted. At MLPerf DLRM's widths (13-512-256-
128, 479-1024-1024-512-256-1, 26 tables at 128) 4,820,224."""

from hpsbench.deploy.dlrm_ensemble import widths


def flops_per_sample(cfg: dict) -> int:
    bottom, top = widths(cfg)
    macs = sum(a * b for w in (bottom, top) for a, b in zip(w, w[1:]))
    feats = len(cfg["rows_per_table"]) + 1
    return 2 * macs + 2 * (feats * (feats - 1) // 2) * cfg["embedding_dim"]


def read(ctx):
    tr, peaks = ctx.trace, ctx.peaks
    if tr is None or peaks is None or "bottom_mlp" not in ctx.cfg or tr.wall_s <= 0:
        return None
    idx = ctx.answered_in(tr.t0, tr.t1)
    if idx.size == 0:
        return None
    samples = sum(ctx.requests[e].samples for e in ctx.results.entry[idx])
    flops = samples * flops_per_sample(ctx.cfg)
    return 100.0 * flops / (tr.wall_s * peaks["f32_flops_per_s"])
