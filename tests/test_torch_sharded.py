"""Sharded tables in the PyTorch port (``parallel/``) against the JAX
package's on its 8 virtual CPU devices: the cases of tests/test_sharded.py,
on the port's meshes ``[cpu] * 8`` and 2 x 4.

Tolerances: none. The port's lookups are bit-identical to the JAX package's
(compared as int32 bit patterns, so the sign of a zero counts) for int8,
int4, fp32 and bf16 tables under both strategies: both quantize the same
rows the same way and dequantize with one f32 multiply; psum adds exact
zeros. The shards' bytes are the JAX package's physical blocks. The plan of
``plan_all_to_all`` is held by meaning (the order of its unique slots
differs, tiers/hbm.py ``dedup_int64``): ``cap``, each owner's bucket as a
set, ``expand`` resolved to slots. Gradients through the lookups: within
rtol 1e-6 of JAX's (JAX's all_to_all gradient sums its shards' copies in
another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hugectr_backend_tpu.parallel.mesh import make_mesh as jmake_mesh
from hugectr_backend_tpu.parallel.sharded_table import ShardedTable as JTable
from hugectr_backend_tpu.parallel.sharded_table import _cached_a2a as _j_a2a
from hugectr_backend_tpu.parallel.sharded_table import _lookup_shardmap as _j_psum
from hugectr_backend_tpu.parallel.sharded_table import plan_all_to_all as jplan
from hugectr_backend_tpu.parallel.sharded_table import sharded_lookup as jlookup
from hugectr_backend_tpu_torch.io.synthetic import expected_vector, make_synthetic_table
from hugectr_backend_tpu_torch.parallel import sharded_table as tst
from hugectr_backend_tpu_torch.parallel.mesh import make_mesh
from hugectr_backend_tpu_torch.parallel.sharded_table import (
    ShardedTable,
    lookup_tables,
    plan_all_to_all,
    route,
    sharded_lookup,
)
from hugectr_backend_tpu_torch.tiers.hbm import dedup_int64

CPU = torch.device("cpu")
QUANTS = ("fp32", "bf16", "int8", "int4")
STRATEGIES = ("psum", "all_to_all")


@pytest.fixture(scope="module")
def meshes(cpu_devices):
    return {
        "8": (jmake_mesh(table=8, data=1), make_mesh(table=8, devices=[CPU] * 8)),
        "2x4": (jmake_mesh(table=4, data=2), make_mesh(table=4, data=2, devices=[CPU] * 8)),
    }


def _pair(meshes, which, n, dim, seed, quant, **kw):
    jm, tm = meshes[which]
    tbl = make_synthetic_table(n, dim, seed=seed, **kw)
    return (tbl, JTable.from_numpy(tbl.keys, tbl.vectors, jm, quant=quant),
            ShardedTable.from_numpy(tbl.keys, tbl.vectors, tm, quant=quant))


def _jax(jt, slots, strategy):
    slots = np.asarray(slots)
    arg = jnp.asarray(slots.astype(np.int32)) if strategy == "psum" else slots
    return np.asarray(jlookup(jt, arg, strategy=strategy))


def _same_bits(got, want) -> bool:
    got = np.ascontiguousarray(got, np.float32)
    want = np.ascontiguousarray(want, np.float32)
    return got.shape == want.shape and np.array_equal(got.view(np.int32), want.view(np.int32))


def _check(jt, tt, slots, strategy):
    got = sharded_lookup(tt, slots, strategy).numpy()
    want = _jax(jt, slots, strategy)
    assert _same_bits(got, want), np.abs(got - want).max()
    return got


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("quant", QUANTS)
def test_lookup_bit_exact_vs_jax(meshes, quant, strategy):
    """test_sharded_fp32_lookup_exact, test_sharded_int8_quantized,
    test_a2a_matches_psum_and_truth and test_sharded_int4_both_strategies:
    every storage kind, both strategies, against JAX and the truth."""
    tbl, jt, tt = _pair(meshes, "8", 1000, 16, 31, quant)
    assert tt.rows_padded == jt.rows_padded and tt.rows_padded % 8 == 0
    q = tbl.keys[np.random.default_rng(0).integers(0, 1000, 333)]
    got = _check(jt, tt, tt.slots_for(q), strategy)
    ref = expected_vector(q, 16)
    bound = {"fp32": 0.0, "bf16": 2 ** -8, "int8": 1 / 254, "int4": 1 / 14}[quant]
    assert np.abs(got - ref).max() <= bound * max(np.abs(ref).max(), 1) + 1e-6


@pytest.mark.parametrize("quant", QUANTS)
def test_shards_hold_the_jax_blocks(meshes, quant):
    """test_shard_memory_is_split: shard k is the JAX package's k-th physical
    block of the interleaved layout, byte for byte, and holds 1/8 of it."""
    tbl, jt, tt = _pair(meshes, "8", 8000, 64 if quant != "int4" else 16, 35, quant)
    jv = np.asarray(jt.values)
    rows = tt.shard_rows
    assert len(tt.values) == 8 and tt.shard_ids == list(range(8))
    for k, v in enumerate(tt.values):
        want = jv[k * rows:(k + 1) * rows]
        if quant == "bf16":
            assert np.array_equal(v.view(torch.int16).numpy(), want.view(np.int16))
        else:
            assert np.array_equal(v.numpy(), want)
        if jt.scales is not None:
            assert np.array_equal(tt.scales[k].numpy(),
                                  np.asarray(jt.scales)[k * rows:(k + 1) * rows])
    assert tt.nbytes_per_shard() == jt.nbytes_per_shard()
    if quant == "int4":
        assert tt.values[0].dtype == torch.uint8 and tt.values[0].shape[1] == 8


@pytest.mark.parametrize("quant", QUANTS)
def test_miss_returns_default(meshes, quant):
    """test_sharded_miss_returns_default: a miss is slot n, the first pad
    row, on shard n % 8; the native index returns it after build."""
    tbl, jt, tt = _pair(meshes, "8", 100, 8, 32, quant)
    slots = tt.slots_for(np.array([-1, 10 ** 12], dtype=np.int64))
    assert tt.index.miss_slot == 100 and (slots == 100).all()
    assert tt.index._native is not None and (tt.index._native.translate(
        np.array([-1], np.int64)) == 100).all()
    for strategy in STRATEGIES:
        got = _check(jt, tt, slots, strategy)
        np.testing.assert_array_equal(got, np.zeros((2, 8), np.float32))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_default_value_row_vs_jax(meshes, strategy):
    """A f32 table's pad rows hold its default_value: misses serve it."""
    jm, tm = meshes["8"]
    tbl = make_synthetic_table(100, 8, seed=32)
    jt = JTable.from_numpy(tbl.keys, tbl.vectors, jm, quant="fp32", default_value=0.5)
    tt = ShardedTable.from_numpy(tbl.keys, tbl.vectors, tm, quant="fp32", default_value=0.5)
    got = _check(jt, tt, tt.slots_for(np.array([-1, tbl.keys[3]], np.int64)), strategy)
    np.testing.assert_array_equal(got[0], 0.5)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("quant", ("fp32", "int8"))
def test_on_data_table_mesh(meshes, quant, strategy):
    """test_sharded_on_data_table_mesh, test_a2a_on_data_table_mesh: the 2 x 4
    mesh, the lookup replicated over data (run once)."""
    tbl, jt, tt = _pair(meshes, "2x4", 512, 16, 34, quant)
    assert len(tt.values) == 4
    q = tbl.keys[np.random.default_rng(2).integers(0, 512, 77)]
    got = _check(jt, tt, tt.slots_for(q), strategy)
    if quant == "fp32":
        np.testing.assert_array_equal(got, expected_vector(q, 16))


def _plan_parity(slots, n_shards, shard_rows):
    got_b, got_e = plan_all_to_all(slots, n_shards, shard_rows)
    want_b, want_e = jplan(slots, n_shards, shard_rows)
    assert got_b.shape == want_b.shape and got_b.dtype == want_b.dtype == np.int32
    assert got_e.dtype == want_e.dtype == np.int32
    uniq = np.unique(slots)
    counts = np.bincount(uniq % n_shards, minlength=n_shards)
    for o in range(n_shards):
        assert sorted(got_b[o, :counts[o]]) == sorted(want_b[o, :counts[o]])
        assert (got_b[o, counts[o]:] == 0).all() and (want_b[o, counts[o]:] == 0).all()
    cap = got_b.shape[1]
    for b, e in ((got_b, got_e), (want_b, want_e)):
        resolved = b.reshape(-1)[e].astype(np.int64) * n_shards + e // cap
        np.testing.assert_array_equal(resolved, slots)
    return got_b, got_e


@pytest.mark.parametrize("n_shards", (2, 8))
def test_plan_parity(n_shards):
    rng = np.random.default_rng(n_shards)
    shard_rows = 700
    slots = rng.integers(0, n_shards * shard_rows, 3000)
    slots[:500] = slots[7]  # a hot slot
    _plan_parity(slots, n_shards, shard_rows)
    _plan_parity(np.zeros(0, np.int64), n_shards, shard_rows)


def test_a2a_duplicates_dedup(meshes):
    """test_a2a_duplicates_dedup: a hot key repeated 500 times costs one
    bucket entry."""
    tbl, jt, tt = _pair(meshes, "8", 800, 8, 42, "fp32")
    q = np.concatenate([np.full(500, tbl.keys[3], np.int64), tbl.keys[:20]])
    slots = tt.slots_for(q)
    buckets, _ = _plan_parity(slots, 8, tt.shard_rows)
    assert buckets.shape[1] <= 32
    np.testing.assert_array_equal(_check(jt, tt, slots, "all_to_all"), expected_vector(q, 8))


def test_a2a_skewed_all_on_one_shard(meshes):
    """test_a2a_skewed_all_on_one_shard, made skewed under the interleaved
    placement: every slot a multiple of 8 (owned by shard 0), so the bucket
    capacity grows to the unique count; results unaffected."""
    tbl, jt, tt = _pair(meshes, "8", 4000, 8, 43, "fp32")
    keys = tt.index.sorted_keys[::8][:100]
    slots = tt.slots_for(keys)
    assert (slots % 8 == 0).all()
    buckets, _ = _plan_parity(slots, 8, tt.shard_rows)
    assert buckets.shape[1] == 128
    for strategy in STRATEGIES:
        np.testing.assert_array_equal(_check(jt, tt, slots, strategy), expected_vector(keys, 8))


@pytest.mark.parametrize("quant", ("int8", "int4"))
def test_a2a_misses_and_quantized(meshes, quant):
    """test_a2a_misses_and_int8 (and its int4 twin)."""
    tbl, jt, tt = _pair(meshes, "8", 2000, 32, 44, quant)
    q = np.concatenate([tbl.keys[:50], np.array([-5, 10 ** 12], np.int64)])
    got = _check(jt, tt, tt.slots_for(q), "all_to_all")
    np.testing.assert_array_equal(got[50:], np.zeros((2, 32), np.float32))


@pytest.mark.parametrize("quant", ("fp32", "bf16"))
def test_negative_zero_per_strategy(meshes, quant):
    """psum adds the masked partials, so a stored -0.0 comes out +0.0, as
    the JAX package's psum gives it; all_to_all keeps -0.0. Both pinned
    against JAX bit for bit."""
    jm, tm = meshes["8"]
    keys = np.arange(100, 140, dtype=np.int64)
    vecs = np.random.default_rng(0).normal(size=(40, 4)).astype(np.float32)
    vecs[3] = [-0.0, 1.0, -0.0, -2.0]
    jt = JTable.from_numpy(keys, vecs, jm, quant=quant)
    tt = ShardedTable.from_numpy(keys, vecs, tm, quant=quant)
    slots = tt.slots_for(keys[:6])
    psum = _check(jt, tt, slots, "psum")
    a2a = _check(jt, tt, slots, "all_to_all")
    assert list(np.signbit(psum[3])) == [False, False, False, True]
    assert list(np.signbit(a2a[3])) == [True, False, True, True]


def test_range_check_and_psum_mask(meshes):
    """plan_all_to_all refuses a slot outside [0, P * shard_rows) with the
    JAX package's error; psum masks such a slot to a zero row as JAX does."""
    tbl, jt, tt = _pair(meshes, "8", 100, 8, 32, "fp32")
    for bad in (tt.rows_padded, -1):
        with pytest.raises(ValueError) as want:
            jplan(np.array([0, bad]), 8, tt.shard_rows)
        with pytest.raises(ValueError) as got:
            sharded_lookup(tt, np.array([0, bad]), "all_to_all")
        assert str(got.value) == str(want.value)
    slots = np.array([0, tt.rows_padded, tt.rows_padded + 5], np.int64)
    got = _check(jt, tt, slots, "psum")
    np.testing.assert_array_equal(got[1:], 0.0)


def test_from_numpy_refusals(meshes):
    jm, tm = meshes["8"]
    tbl = make_synthetic_table(50, 8, seed=1)
    for quant, exc in (("int8", NotImplementedError), ("int4", NotImplementedError),
                       ("fp8", ValueError)):
        with pytest.raises(exc) as want:
            JTable.from_numpy(tbl.keys, tbl.vectors, jm, quant=quant, default_value=1.0)
        with pytest.raises(exc) as got:
            ShardedTable.from_numpy(tbl.keys, tbl.vectors, tm, quant=quant, default_value=1.0)
        assert str(got.value) == str(want.value)


def test_one_k1_launch_per_device_per_lookup(meshes, monkeypatch):
    """Every (table, shard) group of a lookup goes to K1 in one call per
    device: one here (the mesh's 8 entries share the host)."""
    calls = []
    real = tst.gather_dequant_groups
    monkeypatch.setattr(tst, "gather_dequant_groups",
                        lambda *a: calls.append(len(a[0])) or real(*a))
    tbls = [_pair(meshes, "8", 300 + 50 * i, 8, 50 + i, "int8")[2] for i in range(3)]
    keys = [t.index.sorted_keys[:40] for t in tbls]
    for strategy in STRATEGIES:
        calls.clear()
        routed = [route(t, t.slots_for(k), strategy) for t, k in zip(tbls, keys)]
        outs = lookup_tables(tbls, routed, strategy)
        assert calls == [24]  # 3 tables x 8 shards, one launch
        for t, k, o in zip(tbls, keys, outs):
            assert torch.equal(o, sharded_lookup(t, t.slots_for(k), strategy))


def test_dedup_int64_vs_jax():
    from hugectr_backend_tpu.tiers.hbm import dedup_int64 as jdedup

    v = np.random.default_rng(3).integers(-5, 50, 1000)
    v[:3] = np.iinfo(np.int64).min  # the native map's empty key, as a value
    for fn in (dedup_int64, jdedup):
        uniq, inv = fn(v)
        assert uniq.dtype == np.int64 and inv.dtype == np.int64
        np.testing.assert_array_equal(uniq[inv], v)
        assert sorted(uniq) == sorted(np.unique(v))
    # First-seen order (the JAX package's native order; np.unique sorts).
    uniq, _ = dedup_int64(np.array([9, 3, 9, 1], np.int64))
    assert list(uniq) == [9, 3, 1]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_gradient_through_the_lookup_vs_jax(meshes, strategy):
    """d/dv sum(rows ** 2) through each strategy: the port's K1 backward
    (index_add_ of the gradient into the shard's rows) against jax.grad of
    the shard_map lookup, rows in the JAX package's physical order;
    untouched rows exactly 0."""
    jm, tm = meshes["8"]
    tbl, jt, tt = _pair(meshes, "8", 600, 8, 61, "fp32")
    q = tbl.keys[np.random.default_rng(4).integers(0, 600, 200)]
    slots = tt.slots_for(q)
    if strategy == "psum":
        fn = _j_psum(jm, False, jt.rows_padded)
        jg = jax.grad(lambda v: (fn(v, jnp.asarray(slots, jnp.int32)) ** 2).sum())(jt.values)
    else:
        b, e = jplan(slots, 8, jt.rows_padded // 8)
        fn = _j_a2a(jm, False)
        jg = jax.grad(lambda v: (fn(v, jnp.asarray(b), jnp.asarray(e)) ** 2).sum())(jt.values)
    jg = np.asarray(jg)
    vals = [v.clone().requires_grad_(True) for v in tt.values]
    import dataclasses

    rows = lookup_tables([dataclasses.replace(tt, values=vals)], [route(tt, slots, strategy)],
                         strategy)[0]
    grads = torch.autograd.grad((rows ** 2).sum(), vals)
    touched = np.zeros(tt.rows_padded, bool)
    touched[slots] = True
    for k, g in enumerate(grads):
        want = jg[k * tt.shard_rows:(k + 1) * tt.shard_rows]
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-6, atol=0.0)
        assert (g.numpy()[~touched[k::8]] == 0).all()


def test_k1_is_forward_only_and_the_shards_train_through_their_backward(meshes):
    """K1 has no backward: its wrappers raise when autograd would record
    them. The sharded lookup of a table that trains goes through its
    backward (an index_add_ into the shard's rows) and matches the gradient
    of a plain index_select of the unsharded rows."""
    import dataclasses

    from hugectr_backend_tpu_torch.ops.dequant_gather import (
        gather_dequant,
        gather_dequant_groups,
    )

    v = torch.randn(16, 8, requires_grad=True)
    sl = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="forward-only"):
        gather_dequant(v, None, sl)
    with pytest.raises(RuntimeError, match="forward-only"):
        gather_dequant_groups([v], [None], sl, None, (("gather",),), ((0, 4),), (None,))
    with torch.no_grad():
        assert gather_dequant(v, None, sl).shape == (4, 8)
    tbl, _, tt = _pair(meshes, "8", 300, 8, 71, "fp32")
    slots = tt.slots_for(tbl.keys[np.random.default_rng(5).integers(0, 300, 90)])
    w = torch.from_numpy(np.random.default_rng(6).standard_normal((90, 8)).astype(np.float32))
    for strategy in STRATEGIES:
        vals = [x.clone().requires_grad_(True) for x in tt.values]
        rows = lookup_tables([dataclasses.replace(tt, values=vals)], [route(tt, slots, strategy)],
                             strategy)[0]
        grads = torch.autograd.grad((rows * w).sum(), vals)
        full = torch.zeros(tt.rows_padded, 8, requires_grad=True)
        (gfull,) = torch.autograd.grad((full.index_select(0, torch.from_numpy(
            slots.astype(np.int64))) * w).sum(), [full])
        for k, g in enumerate(grads):
            torch.testing.assert_close(g, gfull[k::8], rtol=1e-6, atol=1e-7)
