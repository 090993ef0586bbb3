"""Which tables the fused DLRM path gathers with K1 and which its
interaction kernel folds, as the program reports them (its gauge
``hps_ensemble_fused_folded_table`` on the cell's ensemble)."""

from __future__ import annotations

from hpsbench.deploy import kind

GAUGE = "hps_ensemble_fused_folded_table"


def split(ctx):
    """-> (gathered, folded): sorted table indices, or None where the
    program reports no such gauge for the cell's ensemble."""
    try:
        from hugectr_backend_tpu_torch.serving import metrics
    except ImportError:
        return None
    model = kind(ctx.cfg).model_label(ctx.cfg)
    for m in list(metrics.REGISTRY._metrics):
        if getattr(m, "name", None) != GAUGE:
            continue
        tables = {}
        for labels, v in m.values().items():
            lab = dict(labels)
            if lab.get("model") == model and "table" in lab:
                tables[int(lab["table"])] = bool(v)
        if tables:
            return (sorted(t for t, f in tables.items() if not f),
                    sorted(t for t, f in tables.items() if f))
    return None
