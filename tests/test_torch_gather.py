"""K1 (gather + dequant) and the device-tier layout of the PyTorch port,
held bit-identical to the JAX package.

Tolerance: none. Quantization, key -> slot translation, the arena layout and
gather + dequant are exact operations (one f32 multiply per value), so every
comparison is for identical bytes. The plain version of K1 is held against
``gather_dequant_xla`` on every storage type and scale mode, and against the
Pallas body itself (``dequant_gather(..., use_pallas=True, interpret=True)``)
on int8; the interpreted Pallas gather costs about 30 s of compile per
storage type on a CPU, and its body is the same cast-and-scale for every
type.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hugectr_backend_tpu.ops.dequant_gather import dequant_gather
from hugectr_backend_tpu.tiers import hbm as jhbm
from hugectr_backend_tpu_torch.ops.dequant_gather import gather_dequant, gather_dequant_ref
from hugectr_backend_tpu_torch.tiers import hbm as thbm

QUANTS = ["int8", "fp8", "bf16", "fp32", "int4"]


def _bytes_np(a) -> np.ndarray:
    a = np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


def _bytes_t(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def _table(quant, rows=300, dim=128, seed=0):
    rng = np.random.default_rng(seed)
    vecs = (rng.standard_normal((rows, dim)) * 3).astype(np.float32)
    order = rng.permutation(rows)
    jv, js = jhbm.quantize_host_rows(vecs, quant, 0.5, order=order)
    tv, ts = thbm.quantize_host_rows(vecs, quant, 0.5, order=order)
    return jv, js, tv, ts


@pytest.mark.parametrize("quant", QUANTS)
def test_quantize_host_rows_bit_identical(quant):
    jv, js, tv, ts = _table(quant)
    assert tuple(tv.shape) == tuple(np.asarray(jv).shape)
    np.testing.assert_array_equal(_bytes_t(tv), _bytes_np(jv))
    if js is None:
        assert ts is None
    else:
        np.testing.assert_array_equal(ts.view(np.uint32), js.view(np.uint32))


@pytest.mark.parametrize("quant, scale_mode", [
    (q, m) for q in QUANTS for m in ("device", "per_key", "none")
    if not (m == "device" and q in ("bf16", "fp32"))  # unscaled storage
])
def test_gather_ref_vs_xla(quant, scale_mode):
    jv, js, tv, ts = _table(quant, seed=1)
    rng = np.random.default_rng(2)
    rows = tv.shape[0]
    slots = rng.integers(0, rows, 200).astype(np.int32)
    slots[:3] = rows - 1  # the miss row
    scin = (rng.random(200) + 0.5).astype(np.float32)
    want = jhbm.gather_dequant_xla(
        jnp.asarray(jv), jnp.asarray(js) if scale_mode == "device" else None,
        jnp.asarray(slots))
    if scale_mode == "per_key":
        want = want * jnp.asarray(scin)[:, None]
    got = gather_dequant(
        tv, torch.from_numpy(ts) if scale_mode == "device" else None,
        torch.from_numpy(slots),
        torch.from_numpy(scin) if scale_mode == "per_key" else None)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_gather_ref_vs_pallas_body_int8():
    jv, js, tv, ts = _table("int8", rows=1000, seed=3)
    rng = np.random.default_rng(4)
    slots = rng.integers(0, 1001, 300).astype(np.int32)
    slots[0] = 1000  # the miss row
    scin = (rng.random(300) + 0.5).astype(np.float32)
    jslots = jnp.asarray(slots)
    for mode in ("device", "per_key", "none"):
        want = dequant_gather(jnp.asarray(jv), jnp.asarray(js) if mode == "device" else None,
                              jslots, use_pallas=True, interpret=True)
        if mode == "per_key":
            want = want * jnp.asarray(scin)[:, None]
        got = gather_dequant_ref(
            tv, torch.from_numpy(ts) if mode == "device" else None,
            torch.from_numpy(slots), torch.from_numpy(scin) if mode == "per_key" else None)
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))


def test_gather_empty_and_both_scales():
    _, _, tv, ts = _table("int8", seed=5)
    out = gather_dequant(tv, torch.from_numpy(ts), torch.zeros(0, dtype=torch.int32))
    assert out.shape == (0, 128)
    with pytest.raises(ValueError):
        gather_dequant(tv, torch.from_numpy(ts), torch.zeros(2, dtype=torch.int32),
                       torch.ones(2))


def test_key_index_slots_bit_identical():
    rng = np.random.default_rng(6)
    for keys in (rng.choice(1 << 40, 5000, replace=False).astype(np.int64),
                 rng.permutation(3000).astype(np.int64)):  # searchsorted / direct
        jidx, jorder = jhbm.KeyIndex.build(keys)
        tidx, torder = thbm.KeyIndex.build(keys)
        np.testing.assert_array_equal(jorder, torder)
        assert (jidx.direct, jidx.capacity) == (tidx.direct, tidx.capacity)
        q = np.concatenate([keys[rng.integers(0, keys.size, 4000)],
                            rng.integers(-(1 << 41), 1 << 41, 1000), [-1, 0, keys.size]])
        np.testing.assert_array_equal(jidx.lookup(q), tidx.lookup(q))


@pytest.mark.parametrize("kind", ["onehot", "arena", "solo"])
@pytest.mark.parametrize("quant", ["int8", "fp8", "bf16"])
def test_build_arena_views_layout(kind, quant):
    rng = np.random.default_rng(7)
    tables = []
    for n in (50, 130, 7):
        keys = rng.choice(10_000, n, replace=False).astype(np.int64)
        tables.append((keys, rng.standard_normal((n, 128)).astype(np.float32)))
    dvs = [0.0, 0.25, -1.0]
    jviews = jhbm.build_arena_views(tables, quant=quant, default_values=dvs,
                                    lookup_kind=kind)
    tviews = thbm.build_arena_views(tables, quant=quant, default_values=dvs,
                                    device="cpu", lookup_kind=kind)
    for jv, tv in zip(jviews, tviews):
        assert (jv.offset, jv.block_rows, jv.capacity) == (tv.offset, tv.block_rows, tv.capacity)
        assert jv.nbytes() == tv.nbytes()
    ja, ta = jviews[0].arena, tviews[0].arena
    assert ja.total_rows == ta.total_rows and ja.lookup_kind == ta.lookup_kind
    np.testing.assert_array_equal(_bytes_t(ta.values), _bytes_np(ja.values))
    if ja.scales is None:
        assert ta.scales is None
    else:
        np.testing.assert_array_equal(ta.scales.numpy().view(np.uint32),
                                      np.asarray(ja.scales).view(np.uint32))
    if ja.scales_host is None:
        assert ta.scales_host is None
    else:
        np.testing.assert_array_equal(ta.scales_host, ja.scales_host)


def test_scatter_rows_drops_out_of_range():
    rng = np.random.default_rng(8)
    vals = rng.standard_normal((10, 4)).astype(np.float32)
    slots = np.array([1, 9, 10, 12, 4], np.int32)  # 10, 12: padding past the end
    rows = rng.standard_normal((5, 4)).astype(np.float32)
    want = np.asarray(jhbm.scatter_rows(jnp.asarray(vals), jnp.asarray(slots),
                                        jnp.asarray(rows)))
    src = torch.from_numpy(vals.copy())
    got = thbm.scatter_rows(src, torch.from_numpy(slots), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(src.numpy(), vals)  # functional: input untouched


def test_scatter_rows_wraps_negative_slots():
    """A slot in [-R, 0) wraps to R + slot (NumPy indexing), as JAX's
    ``.at[].set(mode="drop")`` does; -R - 1 and R are still dropped. The
    slots reach distinct rows after the wrap (-R lands on row 0), so the
    order of duplicate writes, which JAX leaves unspecified, plays no part."""
    r = 10
    rng = np.random.default_rng(9)
    vals = rng.standard_normal((r, 4)).astype(np.float32)
    slots = np.array([-1, -r, -r - 1, r, 1], np.int32)
    rows = rng.standard_normal((5, 4)).astype(np.float32)
    want = np.asarray(jhbm.scatter_rows(jnp.asarray(vals), jnp.asarray(slots),
                                        jnp.asarray(rows)))
    got = thbm.scatter_rows(torch.from_numpy(vals.copy()), torch.from_numpy(slots),
                            torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[[r - 1, 0, 1]], rows[[0, 1, 4]])


# ------------------------------------------------- K1 over every group at once

from hypothesis import given, settings, strategies as st  # noqa: E402

from hugectr_backend_tpu.cache.lookup_program import gather_rows_for_groups  # noqa: E402
from hugectr_backend_tpu_torch.cache import lookup_program as tlp  # noqa: E402
from hugectr_backend_tpu_torch.ops.dequant_gather import (  # noqa: E402
    H100_SMS,
    gather_dequant_groups,
    gather_dequant_groups_ref,
    k1_plan,
)

MEMBERS = ((0, 128), (128, 128), (256, 128))  # 128-aligned member blocks, as the arena lays them


def _groups(oh_quant, seed):
    """A lookup of four groups: an arena with device scales, a solo table
    with per-key scales, an unscaled bf16 table and a one-hot group over
    ``oh_quant`` member blocks with per-key scales, some of its slots outside
    their member (inside the arena). -> (JAX args, port args)."""
    rng = np.random.default_rng(seed)
    ja, jas, ta, tas = _table("int8", rows=300, seed=seed)
    js, _, ts, _ = _table("fp8", rows=200, seed=seed + 1)
    jb, _, tb, _ = _table("bf16", rows=90, seed=seed + 2)
    jo, _, to, _ = _table(oh_quant, rows=384, seed=seed + 3)
    counts = (40, 7, 25)
    oh = []
    for (off, size), c in zip(MEMBERS, counts):
        s = rng.integers(off, off + size, c)
        s[::3] = rng.integers(0, 384, len(s[::3]))  # some outside the member
        oh.append(s)
    slots = [rng.integers(0, 300, 33), rng.integers(0, 200, 70), rng.integers(0, 90, 5),
             np.concatenate(oh)]
    slots = [s.astype(np.int32) for s in slots]
    scin = [None, (rng.random(70) + 0.5).astype(np.float32), None,
            (rng.random(sum(counts)) + 0.5).astype(np.float32)]
    meta = (("gather",), ("gather",), ("gather",),
            ("onehot", tuple(o for o, _ in MEMBERS), tuple(z for _, z in MEMBERS), counts))
    jargs = ([jnp.asarray(ja), jnp.asarray(js), jnp.asarray(jb), jnp.asarray(jo)],
             [jnp.asarray(jas), None, None, None], [jnp.asarray(s) for s in slots],
             [None if c is None else jnp.asarray(c) for c in scin], meta)
    slots_cat, sb, scin_cat, cb = tlp.pack_host_args(slots, scin)
    targs = ([ta, ts, tb, to], [torch.from_numpy(tas), None, None, None],
             torch.from_numpy(slots_cat), torch.from_numpy(scin_cat), meta, sb, cb)
    return jargs, targs, oh, counts


@pytest.mark.parametrize("oh_quant", ["int8", "fp8", "bf16", "fp32"])
def test_grouped_ref_vs_jax_gather_rows_for_groups(oh_quant):
    """Every group of a lookup at once, bit-identical to the JAX lookup
    program, with the one-hot group's out-of-member slots giving zero rows
    (the one-hot product's all-zero mask; times the per-key scale)."""
    jargs, targs, oh, counts = _groups(oh_quant, seed=len(oh_quant))
    want = gather_rows_for_groups(*jargs)
    got = gather_dequant_groups_ref(*targs)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_bytes_t(g), _bytes_np(np.asarray(w, np.float32)))
    outside = np.concatenate([(s < o) | (s >= o + z) for s, (o, z) in zip(oh, MEMBERS)])
    assert outside.any() and not got[3].numpy()[outside].any()
    # The wrapper takes the plain version for CPU tensors, and so do the
    # lookup program's entry points.
    via = gather_dequant_groups(*targs)
    lg = tlp.lookup_groups(targs[0], targs[1], targs[2], targs[3], targs[4], targs[5], targs[6])
    for g, v, w in zip(got, via, lg):
        assert torch.equal(g, v) and torch.equal(g, w)


def test_grouped_ref_skips_and_refuses():
    _, targs, _, _ = _groups("int8", seed=3)
    vals, dsc, slots, scin, meta, sb, cb = targs
    skipped = gather_dequant_groups_ref(vals, dsc, slots, scin,
                                        (("skip",),) + meta[1:], sb, cb)
    assert skipped[0] is None and torch.equal(skipped[1], gather_dequant_groups_ref(*targs)[1])
    bad = meta[:3] + (("onehot", (0, 128, 300), (128, 128, 128), meta[3][3]),)
    with pytest.raises(ValueError, match="inside the table"):
        gather_dequant_groups_ref(vals, dsc, slots, scin, bad, sb, cb)
    packed = vals[:3] + [torch.zeros((384, 64), dtype=torch.uint8)]
    with pytest.raises(TypeError, match="nibble-packed"):
        gather_dequant_groups_ref(packed, dsc, slots, scin, meta, sb, cb)
    # The plain version serves CPU tensors only: tables elsewhere are refused.
    elsewhere = vals[:3] + [vals[3].to("meta")]
    with pytest.raises(ValueError, match="slots on the CPU"):
        gather_dequant_groups(elsewhere, dsc, slots, scin, meta, sb, cb)


def test_grouped_plan_at_the_criteo_lookups():
    """The fold predict's groups (an arena of 16,384 rows and 8 solo groups
    of 4,096) and the K2 path's (a one-hot group of 14 members of 4,096
    more): one launch, every unit a warp resident at once."""
    fold = k1_plan([16384] + [4096] * 8)
    assert fold.rows == 16 and fold.units == 3072 and fold.grid == 384
    assert k1_plan([4096]) == (128, 256, 4, 1024)  # one big table: 128 CTAs
    k2 = k1_plan([4096] * 14 + [16384] + [4096] * 8)
    assert k2.rows == 32 and k2.units == 3328 and k2.grid == 3 * H100_SMS  # persistent


def k1_units(plan, group_rows):
    """The rows each unit of ``plan`` covers, in the order the kernel numbers
    them: ``(group, first row, rows)``."""
    return [(g, r0, min(plan.rows, n - r0))
            for g, n in enumerate(group_rows) for r0 in range(0, n, plan.rows)]


@settings(max_examples=300, deadline=None)
@given(rows=st.lists(st.integers(1, 70_000), min_size=1, max_size=40),
       sms=st.sampled_from([H100_SMS, 1, 7, 114]))
def test_grouped_plan_covers_every_row_once(rows, sms):
    plan = k1_plan(rows, sms)
    assert plan.rows in (4, 8, 16, 32) and plan.threads == 256
    assert 1 <= plan.grid <= 3 * sms and plan.grid * 8 >= min(plan.units, 3 * sms * 8)
    units = k1_units(plan, rows)
    assert len(units) == plan.units
    covered = {}
    for g, r0, n in units:
        assert 1 <= n <= plan.rows
        covered.setdefault(g, []).append((r0, n))
    for g, n in enumerate(rows):
        spans = sorted(covered[g])
        assert spans[0][0] == 0 and sum(c for _, c in spans) == n
        assert all(a + c == b for (a, c), (b, _) in zip(spans, spans[1:]))
    # Smaller units only while they all fit the card at once.
    if plan.rows > 4:
        assert sum(-(-n // (plan.rows // 2)) for n in rows) > 3 * sms * 8


def test_grouped_plan_refuses():
    with pytest.raises(ValueError):
        k1_plan([4096, 0])
    with pytest.raises(ValueError):
        k1_plan([1] * 257)
