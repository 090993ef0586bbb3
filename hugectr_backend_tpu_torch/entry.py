"""Multi-shard dry run: one sharded training step and sharded serving.

The counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``:

    from hugectr_backend_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(8, device="cuda:0")   # 8 mesh entries on one card
    dryrun_multichip(8, device="cpu")      # on the host

It builds a (data x table) mesh of ``n_devices`` entries (2 table shards when
``n_devices`` is even), row-shards an f32 table and runs ONE training step:
the psum lookup, the DLRM forward, BCE, gradients through the exchange for
the dense parameters and the shards, then SGD. The shards' gradients must
equal those of the same step on the unsharded table. Then a gradient step
through the all_to_all lookup (untouched rows exactly 0), and the sharded
int8 fused DLRM predict with one miss against a host dequant.

With ``torch.distributed`` initialised, the mesh spans the process group
(each rank holds ``n_devices // world`` entries, the table axis split over
the ranks), as the JAX dry run spans ``jax.distributed``'s processes.
``device``: None puts the entries on the visible cards, one each (and raises
when there are too few); ``"cpu"`` or ``"cuda:<i>"`` puts every entry there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The JAX dry run's loss: mean(max(l, 0) - l y + log1p(exp(-|l|)))."""
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One sharded train step and the sharded serving checks (see the module
    docstring). -> {"loss", "psum_vs_unsharded_grad", "predict_max_abs_err"}."""
    import torch.distributed as dist

    from hugectr_backend_tpu_torch.io.synthetic import make_synthetic_table
    from hugectr_backend_tpu_torch.models.dlrm import DLRM
    from hugectr_backend_tpu_torch.ops.quantize import quantize_rows_int8
    from hugectr_backend_tpu_torch.parallel.fused_sharded import make_sharded_dlrm_server
    from hugectr_backend_tpu_torch.parallel.mesh import make_mesh
    from hugectr_backend_tpu_torch.parallel.sharded_table import (
        ShardedTable,
        lookup_tables,
        route,
        sharded_lookup,
    )
    from hugectr_backend_tpu_torch.tiers.hbm import default_device

    group = dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    world = 1 if group is None else dist.get_world_size(group)
    tp = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // tp
    if tp % world:
        tp, dp = world * tp, n_devices // (world * tp)
    devices = None if device is None else [default_device(device)] * (n_devices // world)
    mesh = make_mesh(table=tp, data=dp, devices=devices, group=group)
    out = mesh.out_device

    batch, keys_per_sample, dim, num_dense = 4 * dp, 4, 16, 13
    tbl = make_synthetic_table(64 * tp, dim, seed=0)
    st = ShardedTable.from_numpy(tbl.keys, tbl.vectors, mesh, quant="fp32")
    model = DLRM(num_dense, keys_per_sample, bottom_widths=(32, dim), top_widths=(32, 1))
    model.init_flax_(torch.Generator().manual_seed(0))
    model = model.to(out)

    r = np.random.default_rng(0)
    slots = st.slots_for(tbl.keys[r.integers(0, tbl.num_rows, batch * keys_per_sample)])
    dense_np = np.asarray(r.standard_normal((batch, num_dense)), np.float32)
    dense = torch.from_numpy(dense_np).to(out)
    labels = torch.from_numpy(r.integers(0, 2, batch).astype(np.float32)).to(out)
    params = list(model.parameters())
    lr = 0.1

    def step(values):
        """Loss and gradients (dense params, then ``values``) of one batch
        looked up through ``values``."""
        if isinstance(values, list):
            flat = lookup_tables([dataclasses.replace(st, values=values)],
                                 [route(st, slots, "psum")], "psum")[0]
        else:
            flat = values.index_select(0, torch.from_numpy(slots.astype(np.int64)).to(out))
        logits = model(dense, flat.view(batch, keys_per_sample, dim))
        loss = _bce(logits, labels)
        wrt = params + (values if isinstance(values, list) else [values])
        return loss, torch.autograd.grad(loss, wrt)

    # The train step: psum lookup through the exchange, gradients for the
    # dense params and every shard, SGD.
    shards = [v.clone().requires_grad_(True) for v in st.values]
    loss, grads = step(shards)
    assert torch.isfinite(loss), f"non-finite loss {loss}"
    new_params = [p.detach() - lr * g for p, g in zip(params, grads)]
    new_shards = [s.detach() - lr * g for s, g in zip(shards, grads[len(params):])]
    for s, v in zip(new_shards, st.values):
        assert s.device == v.device and s.shape == v.shape, (s.device, s.shape)
    assert all(torch.isfinite(p).all() for p in new_params)
    # Against the same step on the unsharded table (every rank holds the
    # whole table's rows here: the slots are global).
    full = torch.from_numpy(np.concatenate(
        [tbl.vectors[np.argsort(tbl.keys, kind="stable")],
         np.zeros((st.rows_padded - tbl.num_rows, dim), np.float32)])).to(out)
    full_loss, full_grads = step(full.clone().requires_grad_(True))
    gfull = full_grads[-1]
    worst = 0.0
    for k, g in zip(st.shard_ids, grads[len(params):]):
        want = gfull[k::st.n_shards]
        torch.testing.assert_close(g.to(out), want, rtol=1e-5, atol=1e-7)
        worst = max(worst, float((g.to(out) - want).abs().max()))
    torch.testing.assert_close(loss, full_loss, rtol=1e-6, atol=1e-7)

    # all_to_all (host dedup + bucket routing): forward against psum, and a
    # gradient step through the exchange.
    with torch.no_grad():
        a2a = sharded_lookup(st, slots, strategy="all_to_all")
        psum_out = sharded_lookup(st, slots)
    torch.testing.assert_close(a2a, psum_out, rtol=1e-6, atol=0.0)
    shards2 = [v.clone().requires_grad_(True) for v in st.values]
    rows = lookup_tables([dataclasses.replace(st, values=shards2)],
                         [route(st, slots, "all_to_all")], "all_to_all")[0]
    g2 = torch.autograd.grad((rows ** 2).sum(), shards2)
    new_tv = [s.detach() - 0.1 * g for s, g in zip(shards2, g2)]
    assert all(torch.isfinite(t).all() for t in new_tv)
    counts = np.bincount(slots, minlength=st.rows_padded)
    for k, g, v in zip(st.shard_ids, g2, st.values):
        c = torch.from_numpy(counts[k::st.n_shards].astype(np.float32)).to(g.device)
        assert torch.equal(g[c == 0], torch.zeros_like(g[c == 0])), "untouched rows got a gradient"
        torch.testing.assert_close(g, 2 * v * c[:, None], rtol=1e-6, atol=0.0)

    # Sharded fused serving: int8 rows and scales, the all_to_all lookup and
    # the DLRM forward, against a host dequant, with one miss.
    t0 = make_synthetic_table(48 * tp, dim, seed=1)
    t1 = make_synthetic_table(32 * tp, dim, seed=2)
    st0 = ShardedTable.from_numpy(t0.keys, t0.vectors, mesh, quant="int8")
    st1 = ShardedTable.from_numpy(t1.keys, t1.vectors, mesh, quant="int8")
    k0, k1 = keys_per_sample - 1, 1
    server = make_sharded_dlrm_server(mesh, [st0, st1], [k0, k1], model)
    q0 = t0.keys[r.integers(0, t0.num_rows, batch * k0)]
    q1 = t1.keys[r.integers(0, t1.num_rows, batch * k1)]
    q1[0] = -1  # one miss: the default row through the sharded int8 path
    logits = server.predict([q0, q1], dense_np)

    def dequant_ref(tbl_, q):
        qv, s = quantize_rows_int8(np.asarray(tbl_.vectors, np.float32))
        deq = qv.astype(np.float32) * s[:, None]
        pos = {int(k): i for i, k in enumerate(tbl_.keys)}
        return np.stack([deq[pos[int(k)]] if int(k) in pos else np.zeros(dim, np.float32)
                         for k in q])

    emb_ref = np.concatenate([dequant_ref(t0, q0).reshape(batch, k0, dim),
                              dequant_ref(t1, q1).reshape(batch, k1, dim)], axis=1)
    with torch.no_grad():
        want = model(dense, torch.from_numpy(emb_ref).to(out))
    torch.testing.assert_close(logits, want, rtol=2e-4, atol=2e-4)
    return {"loss": float(loss.detach()), "psum_vs_unsharded_grad": worst,
            "predict_max_abs_err": float((logits - want).abs().max())}
