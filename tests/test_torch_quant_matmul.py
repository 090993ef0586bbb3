"""K5 (the w8a8 dense layer) of the PyTorch port against the JAX package,
and its launch plans.

On the CPU the port's wrapper takes the plain version, ``w8a8_dense_plain``;
the CUDA kernel is held against that plain version on the card by
``chip_smoke.py``. The launch plans (``k5_plan``) are plain Python: they are
checked here against an H100's limits (132 SMs, 232,448 bytes of shared
memory a block).

Tolerances:
- Against the XLA formulation ``xla_w8a8``: equal for act None and relu (the
  int32 sum is exact, and both sides divide, round half to even and rescale
  as ``(f32(acc) * xs) * wscale + bias`` in IEEE f32); rtol 1e-6, atol 1e-6
  for sigmoid, tanh and gelu, whose library implementations differ by a few
  ulp.
- Against the Pallas body run in interpret mode: rtol 1e-6, atol 1e-6. XLA's
  CPU compiler rewrites two steps of the interpreted body (not of
  ``xla_w8a8``): ``absmax / 127.0`` becomes a multiply by fl(1/127), which
  rounds ``xs`` one ulp away on some rows (4 of the 64 here; no element of
  xq flips for these inputs), and ``(f32(acc) * xs) * wscale + bias`` is
  contracted into one FMA. Without a bias, the rows whose ``xs`` rounds the
  same are equal for None and relu.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from hugectr_backend_tpu.models.quant_dense import quantize_activations as jax_quant_act
from hugectr_backend_tpu.ops.quant_matmul import w8a8_dense as jax_w8a8
from hugectr_backend_tpu.ops.quant_matmul import xla_w8a8
from hugectr_backend_tpu_torch.ops import kernels
from hugectr_backend_tpu_torch.ops import quant_matmul as qm
from hugectr_backend_tpu_torch.ops.quant_matmul import (
    GEMV_MAX_K,
    H100_SMS,
    MAX_K,
    MAX_SMEM,
    TILES,
    k5_plan,
    narrow_smem,
    quantize_activations,
    tile_smem,
    w8a8_dense,
    w8a8_dense_plain,
    wg_smem,
)

ACTS = [None, "relu", "sigmoid", "tanh", "gelu"]
RTOL = ATOL = 1e-6
# (M, K, N): the Pallas-eligible layer, then ragged shapes as the DLRM gives
# them (K = 13 bottom layer 0, K = 479 top layer 0, N = 1 the last layer).
SHAPES = [(64, 320, 256), (7, 13, 1), (40, 479, 24), (9, 256, 1)]


def _layer(m, k, n, seed=0):
    rng = np.random.default_rng(seed + m + k + n)
    x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    x[m // 2] = 0.0  # an all-zero row: xs = 1e-12 / 127, y = bias
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)  # the JAX layout [K, N]
    ws = (rng.random(n) * 0.01).astype(np.float32)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return x, wq, ws, b


def _port(x, wq, ws, b, act, fn=w8a8_dense_plain):
    return fn(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(wq.T)),
              torch.from_numpy(ws), None if b is None else torch.from_numpy(b), act).numpy()


def _jax(fn, x, wq, ws, b, act, **kw):
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ws),
                         None if b is None else jnp.asarray(b), act, **kw))


def _check(got, want, act):
    assert got.shape == want.shape and got.dtype == np.float32
    if act in (None, "relu"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_quantize_activations_bit_identical():
    x, *_ = _layer(33, 479, 1)
    jq, js = jax_quant_act(jnp.asarray(x))
    tq, ts = quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_xla_formulation(shape, act, bias):
    x, wq, ws, b = _layer(*shape)
    b = b if bias else None
    _check(_port(x, wq, ws, b, act), _jax(xla_w8a8, x, wq, ws, b, act), act)


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("act", ACTS)
def test_plain_matches_pallas_body(act, bias):
    """The Pallas kernel body, interpreted on the CPU (M % 8 == 0)."""
    x, wq, ws, b = _layer(64, 320, 256)
    b = b if bias else None
    want = _jax(jax_w8a8, x, wq, ws, b, act, interpret=True)
    got = _port(x, wq, ws, b, act)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    absmax = np.maximum(np.abs(x).max(axis=1), np.float32(1e-12))
    same = absmax / np.float32(127.0) == absmax * np.float32(1.0 / 127.0)
    assert 0 < same.sum() < same.size
    if not bias:
        _check(got[same], want[same], act)


@pytest.mark.parametrize("act", ["relu", None])
def test_ragged_shape_through_jax_entry_point(act):
    """M = 7 is not Pallas-eligible: the JAX entry point takes xla_w8a8."""
    x, wq, ws, b = _layer(7, 13, 1)
    _check(_port(x, wq, ws, b, act, fn=w8a8_dense),
           _jax(jax_w8a8, x, wq, ws, b, act, interpret=True), act)


@pytest.mark.parametrize("k", [479, 13])
def test_weight_row_padding_is_ignored(k):
    """``wq`` may carry columns past K (rows padded to 16 bytes): they do
    not enter the product, whatever they hold."""
    x, wq, ws, b = _layer(16, k, 40)
    kw = -(-k // 16) * 16 + 16
    padded = np.random.default_rng(5).integers(-127, 128, (kw, 40)).astype(np.int8)
    padded[:k] = wq
    _check(_port(x, padded, ws, b, "relu"), _jax(xla_w8a8, x, wq, ws, b, "relu"), "relu")


def test_cpu_tensors_take_the_plain_version():
    x, wq, ws, b = _layer(9, 256, 1)
    before = kernels.launches["w8a8_dense"]
    np.testing.assert_array_equal(_port(x, wq, ws, b, "relu", fn=w8a8_dense),
                                  _port(x, wq, ws, b, "relu"))
    assert kernels.launches["w8a8_dense"] == before


@pytest.mark.parametrize("case", ["act", "k", "scale", "bias", "empty_k"])
def test_bad_arguments_raise(case):
    x = torch.zeros(4, 8)
    wq = torch.zeros(3, 8, dtype=torch.int8)
    ws, b, act = torch.ones(3), torch.zeros(3), "relu"
    if case == "act":
        act = "swish"
    elif case == "k":
        wq = torch.zeros(3, 7, dtype=torch.int8)
    elif case == "scale":
        ws = torch.ones(4)
    elif case == "bias":
        b = torch.zeros(2)
    else:
        x, wq = torch.zeros(4, 0), torch.zeros(3, 0, dtype=torch.int8)
    with pytest.raises(ValueError):
        w8a8_dense(x, wq, ws, b, act)


# The DLRM's 8 K5 layers at batch 4096: (K, N, weight rows a multiple of 16
# bytes). The serving path pads only the permuted top layer's rows (479 ->
# 480); the bottom layer's K = 13 rows stay unpadded.
DLRM_LAYERS = [(13, 512, False), (512, 256, True), (256, 128, True), (479, 1024, True),
               (1024, 1024, True), (1024, 512, True), (512, 256, True), (256, 1, True)]
SM_SMEM = 233472  # shared memory of one H100 SM, 1 KB of it reserved per block


# The plan each DLRM layer takes at M = 4096, the fastest measured on an
# H100 (PERF.md): variant, tile rows and columns, ring stages.
DLRM_PLANS = {13: ("tile", 64, 128, 4), 512: ("wgmma", 64, 128, 4), 256: ("narrow", 16, 64, 0),
              479: ("wgmma", 128, 128, 3), 1024: ("wgmma", 128, 128, 3)}


@pytest.mark.parametrize("k, n, wvec", DLRM_LAYERS, ids=lambda v: str(v))
def test_plan_fills_the_card_on_the_dlrm_layers(k, n, wvec):
    """Every DLRM layer at M = 4096 takes its measured plan, and fills an
    H100: every kernel of the layer puts a CTA on at least 128 of the 132
    SMs in one wave (its CTAs per SM fit in an SM's shared memory), and the
    kernel that reads x (the GEMV, the narrow kernel, the quantize kernel)
    runs at least two CTAs per SM, but for K = 13, whose product quantizes
    its own 13 columns."""
    plan = k5_plan(4096, n, k, H100_SMS, wvec)
    want = ("gemv", 8, 1, 0) if n <= 8 else ("wgmma", 64, 128, 3) if (k, n) == (1024, 512) \
        else DLRM_PLANS[k]
    assert (plan.variant, plan.bm, plan.bn, plan.stages) == want
    ctas = plan.grid[0] * plan.grid[1]
    per_sm = -(-ctas // H100_SMS)
    assert 128 <= ctas and per_sm * (plan.smem + 1024) <= SM_SMEM
    if per_sm == 1 and plan.qgrid:  # spread one to an SM, not two to the first SMs free
        assert 2 * (plan.smem + 1024) > SM_SMEM
    reads_x = plan.qgrid if plan.qgrid else ctas
    assert reads_x >= 2 * H100_SMS or k == 13
    if plan.qgrid:
        assert plan.qgrid == 4096 // 8  # a warp per row


@pytest.mark.parametrize("m, n, k, bn, ctas", [
    (4096, 512, 13, 128, 264), (4096, 128, 256, 64, 264), (4096, 256, 512, 128, 132),
    (1, 1024, 300, 64, 264), (63, 9, 64, 128, 264), (4097, 257, 512, 128, 100),
    (70_000, 4096, 1, 64, 264)])
def test_narrow_grid_covers_every_item_once(m, n, k, bn, ctas):
    """The narrow kernel's persistent walk (CTA c: slice c % S, row items c /
    S, c / S + grid / S, ...) meets every (item, slice) exactly once, and
    its grid is within the asked CTAs (but at least one per slice)."""
    plan = qm._narrow_plan(m, n, k, bn, ctas)
    grid, slices, items = plan.grid[0], -(-n // bn), -(-m // 16)
    assert grid % slices == 0 and slices <= grid <= max(ctas, slices)
    seen = [(tm, c % slices) for c in range(grid) for tm in range(c // slices, items, grid // slices)]
    assert sorted(seen) == [(tm, s) for tm in range(items) for s in range(slices)]
    assert plan.smem == narrow_smem(bn, k) <= MAX_SMEM


@pytest.mark.parametrize("m, n, bm, stages", [(4096, 1024, 128, 3), (4096, 256, 64, 4),
                                              (65, 1024, 64, 3), (4097, 1000, 128, 3),
                                              (1, 512, 64, 4)])
def test_wgmma_grid_is_one_cta_per_tile(m, n, bm, stages):
    """The wgmma product: a CTA per bm x 128 output tile, its ring and the
    output tile laid over it within a block's shared memory; a grid of at
    most one CTA per SM asks for enough that no SM takes two."""
    plan = qm._wgmma_plan(m, n, 1024, bm, stages)
    assert plan.grid == (-(-m // bm), -(-n // 128)) and plan.qgrid == -(-m // 8)
    one_per_sm = plan.grid[0] * plan.grid[1] <= H100_SMS
    assert plan.smem == (max(wg_smem(bm, stages), qm._ONE_PER_SM) if one_per_sm
                         else wg_smem(bm, stages)) <= MAX_SMEM
    assert not one_per_sm or 2 * (plan.smem + 1024) > SM_SMEM


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("k", [13, 256, 1024, GEMV_MAX_K])
def test_n_up_to_8_takes_the_gemv_body(n, k):
    plan = k5_plan(4096, n, k)
    assert plan.variant == "gemv" and plan.grid == (512, 1) and plan.qgrid == 0
    assert k5_plan(4096, 9, k).variant != "gemv"


PRODUCTS = ([("narrow", bn) for bn in (64, 128)] + [("tile", 64, 128, 4)]
            + [("tile", bm, bn, 8) for bm, bn in TILES]
            + [("wgmma", bm, st) for bm, st in ((128, 3), (64, 3), (64, 4))])


def _product_plan(m, n, k, product):
    if product[0] == "narrow":
        return qm._narrow_plan(m, n, k, product[1], 4 * H100_SMS)
    if product[0] == "tile":
        return qm._tile_plan(m, n, k, *product[1:])
    return qm._wgmma_plan(m, n, k, *product[1:])


@settings(max_examples=400, deadline=None)
@given(m=st.integers(1, 70_000), n=st.integers(1, 4096), k=st.integers(1, MAX_K),
       wvec=st.booleans(), product=st.sampled_from([None] + PRODUCTS))
def test_every_shape_has_a_plan_that_fits(m, n, k, wvec, product):
    if product is not None and product[0] == "narrow" and k > 512:
        product = None  # the narrow kernel quantizes K <= 512 in registers
    if product == ("tile", 64, 128, 4) and k > 64:
        product = None  # the in-product quantize takes one chunk of K
    plan = (k5_plan(m, n, k, H100_SMS, wvec) if product is None or n <= 8
            else _product_plan(m, n, k, product))
    assert plan.smem <= MAX_SMEM and plan.threads == 256
    assert 1 <= plan.grid[1] <= 65535
    if plan.variant == "gemv":
        assert n <= 8 and plan.grid[0] * 8 >= min(m, 8 << 20) and plan.qgrid == 0
    elif plan.variant == "narrow":
        slices = -(-n // plan.bn)
        assert k <= 512 and plan.qgrid == 0 and plan.smem == narrow_smem(plan.bn, k)
        assert plan.grid[0] % slices == 0 and slices <= plan.grid[0] <= slices * -(-m // 16)
    else:
        need = (wg_smem(plan.bm, plan.stages) if plan.variant == "wgmma"
                else tile_smem(plan.bm, plan.bn, plan.stages))
        assert plan.grid == (-(-m // plan.bm), -(-n // plan.bn))
        in_product = plan.variant == "tile" and plan.stages == 4
        spread = not in_product and plan.grid[0] * plan.grid[1] <= H100_SMS
        assert plan.smem == (max(need, qm._ONE_PER_SM) if spread else need)
        assert not in_product or k <= 64
        assert plan.qgrid == (0 if in_product else -(-m // 8))  # the quantize kernel: a warp per row
        assert plan.variant == "tile" or wvec or product is not None


def test_plan_refuses_what_the_kernel_does_not_take():
    for m, n, k in ((0, 8, 8), (8, 0, 8), (8, 8, 0), (8, 8, MAX_K + 1)):
        with pytest.raises(ValueError):
            k5_plan(m, n, k)
    with pytest.raises(ValueError):  # the mma.sync product's grid has 65535 column tiles
        qm._tile_plan(1, 65535 * 64 + 1, 1024, 32, 64)
    with pytest.raises(ValueError):  # the in-product quantize takes one chunk of K
        qm._tile_plan(64, 64, 65, 64, 128, 4)


@pytest.mark.parametrize("k", [2945, 4096])
@pytest.mark.parametrize("act", ["relu", None])
def test_plain_matches_xla_formulation_past_the_old_k_limit(k, act):
    """K past 2,944, the card's former limit: the plain version against
    ``xla_w8a8`` (the JAX package takes any K)."""
    x, wq, ws, b = _layer(9, k, 5)
    _check(_port(x, wq, ws, b, act), _jax(xla_w8a8, x, wq, ws, b, act), act)


@pytest.mark.parametrize("k", [2945, 4096, GEMV_MAX_K])
@pytest.mark.parametrize("n", [1, 8, 300, 1024])
def test_plan_takes_k_past_the_old_limit(k, n):
    """Every path past K = 2,944: the GEMV's weight rows still fit a block's
    shared memory up to GEMV_MAX_K, the products stream K after the quantize
    kernel."""
    plan = k5_plan(4096, n, k)
    assert plan.smem <= MAX_SMEM
    if n <= 8:
        assert plan.variant == "gemv" and plan.smem == n * -(-k // 128) * 128
    else:
        assert plan.variant in ("tile", "wgmma") and plan.qgrid == 4096 // 8
    assert 8 * -(-GEMV_MAX_K // 128) * 128 <= MAX_SMEM < 8 * (GEMV_MAX_K + 128)
