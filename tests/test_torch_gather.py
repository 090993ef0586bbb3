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
