"""Quantized dense layers of the PyTorch port (models/quant_dense.py, the
quantized MLP and DLRM of models/dlrm.py) against the JAX package, on
weights carried across.

Tolerances:
- ``quantize_weight``: none (identical bytes and scales; fp8 through
  ``torch.float8_e4m3fn`` vs ``ml_dtypes``).
- ``QuantDense`` and the quantized ``MLP``: equal for w8a8 at any width (an
  exact int32 sum, then the same IEEE steps; the JAX package runs its XLA
  formulation on the CPU). The weight-only int8/fp8 product is an f32
  matmul on both sides, PyTorch's and XLA's, which may sum in different
  orders: rtol 1e-5, atol 1e-6 (one layer of 64 x 64 -> 48 happens to agree
  bit for bit, and is held to that).
- ``DLRM(quant_fmt=...)``: |delta| <= 1e-2 * max|logit|. The Flax model runs
  with ``HPS_PALLAS_INTERPRET=1`` (the Pallas interaction body); the two
  interactions sum the same bf16 products in another f32 order, so an
  element of the top layer-0 input can sit one ulp apart, and where that
  element is the row's absmax, or sits on a rounding boundary, w8a8 moves
  it by one quantization step (1/127 of the row absmax).
- ``mixed_precision``: the same bar. On the CPU, XLA ignores
  ``jax.default_matmul_precision("bfloat16")`` (the JAX server's switch), so
  the reference is the Flax DLRM's arithmetic written out with explicit bf16
  operands and ``preferred_element_type=float32``; an activation one f32 ulp
  apart on the two sides can round to a bf16 one step (2^-8) apart.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hugectr_backend_tpu.models import quant_dense as jqd
from hugectr_backend_tpu.models.dlrm import DLRM as FlaxDLRM
from hugectr_backend_tpu.models.dlrm import MLP as FlaxMLP
from hugectr_backend_tpu.models.dlrm import DotInteraction as FlaxDot
from hugectr_backend_tpu_torch.models.dlrm import DLRM, MLP, load_flax_dlrm_params
from hugectr_backend_tpu_torch.models.quant_dense import (
    QuantDense,
    quantize_model_params,
    quantize_weight,
)

FMTS = ["int8", "fp8", "w8a8"]
LOGIT_BAR = 1e-2


def _bytes(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.uint8).numpy()


def _np_bytes(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _layer_state(p) -> dict:
    """One Flax QuantDense's params -> the port's QuantDense state_dict."""
    state = load_flax_dlrm_params({"MLP_0": {"QuantDense_0": p}, "MLP_1": {}})
    return {k[len("bottom.layers.0."):]: v for k, v in state.items()}


def _flax_layer(rng, k, n, fmt):
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    q, s = jqd.quantize_weight(w, fmt)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return {"kernel_q": jnp.asarray(q), "kernel_scale": jnp.asarray(s), "bias": jnp.asarray(b)}


@pytest.mark.parametrize("fmt", FMTS)
def test_quantize_weight_bytes_match_jax(fmt):
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((96, 40)) * 0.3).astype(np.float32)  # [in, out]
    w[:, 7] = 0.0  # an all-zero column: scale from absmax 1
    w[3, 9] = 1e4  # a column dominated by one value
    jq, js = jqd.quantize_weight(w, fmt)
    tq, ts = quantize_weight(w.T, fmt)
    assert tq.dtype == (torch.float8_e4m3fn if fmt == "fp8" else torch.int8)
    assert tuple(tq.shape) == (40, 96)
    np.testing.assert_array_equal(_bytes(tq), np.ascontiguousarray(_np_bytes(jq).T))
    np.testing.assert_array_equal(ts.numpy(), js)
    assert not np.isnan(tq.float().numpy()).any()


@pytest.mark.parametrize("act", ["relu", None])
@pytest.mark.parametrize("fmt", FMTS)
def test_quant_dense_matches_flax(fmt, act):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    p = _flax_layer(rng, 64, 48, fmt)
    want = np.asarray(jqd.QuantDense(48, fmt, activation=act).apply({"params": p},
                                                                    jnp.asarray(x)))
    layer = QuantDense(64, 48, fmt, activation=act)
    layer.load_state_dict(_layer_state(p))
    got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", FMTS)
def test_quant_dense_wide_k(fmt):
    """K = 479 (the DLRM's top layer 0): w8a8 stays exact; the weight-only
    f32 matmuls sum in different orders."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 479)).astype(np.float32)
    p = _flax_layer(rng, 479, 256, fmt)
    want = np.asarray(jqd.QuantDense(256, fmt, activation="relu").apply({"params": p},
                                                                       jnp.asarray(x)))
    layer = QuantDense(479, 256, fmt, activation="relu")
    layer.load_state_dict(_layer_state(p))
    got = layer(torch.from_numpy(x)).numpy()
    if fmt == "w8a8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("final_activation", [True, False])
@pytest.mark.parametrize("fmt", FMTS)
def test_quant_mlp_matches_flax(fmt, final_activation):
    rng = np.random.default_rng(4)
    widths = (32, 24, 8)
    x = rng.standard_normal((8, 20)).astype(np.float32)
    flax_mlp = FlaxMLP(widths, final_activation=final_activation, quant_fmt=fmt)
    dims = (20, *widths)
    params = {f"QuantDense_{i}": _flax_layer(rng, a, b, fmt)
              for i, (a, b) in enumerate(zip(dims, dims[1:]))}
    want = np.asarray(flax_mlp.apply({"params": params}, jnp.asarray(x)))
    mlp = MLP(20, widths, final_activation=final_activation, quant_fmt=fmt)
    state = load_flax_dlrm_params({"MLP_0": params, "MLP_1": {}})
    mlp.load_state_dict({k[len("bottom."):]: v for k, v in state.items()})
    got = mlp(torch.from_numpy(x)).numpy()
    if fmt == "w8a8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _dlrm_case(seed, b=16, nd=5, tables=4, d=32):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((b, nd)).astype(np.float32)
    emb = rng.standard_normal((b, tables, d)).astype(np.float32)
    f32 = FlaxDLRM(bottom_widths=(16, d), top_widths=(32, 16, 1))
    params = f32.init(jax.random.PRNGKey(seed), jnp.zeros((b, nd)), jnp.zeros((b, tables, d)))
    return dense, emb, params


def _logits_close(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= LOGIT_BAR * np.abs(want).max()


@pytest.mark.parametrize("fmt", FMTS)
def test_quant_dlrm_matches_flax(monkeypatch, fmt):
    dense, emb, params = _dlrm_case(5)
    qparams = jqd.quantize_model_params(params, fmt="int8" if fmt == "w8a8" else fmt)
    monkeypatch.setenv("HPS_PALLAS_INTERPRET", "1")
    flax_model = FlaxDLRM(bottom_widths=(16, 32), top_widths=(32, 16, 1), quant_fmt=fmt)
    want = np.asarray(flax_model.apply(qparams, jnp.asarray(dense), jnp.asarray(emb)))
    model = DLRM(5, 4, bottom_widths=(16, 32), top_widths=(32, 16, 1), quant_fmt=fmt)
    model.load_state_dict(load_flax_dlrm_params(jax.tree_util.tree_map(np.asarray, qparams)))
    with torch.no_grad():
        got = model(torch.from_numpy(dense), torch.from_numpy(emb)).numpy()
    _logits_close(got, want)


@pytest.mark.parametrize("fmt", FMTS)
def test_quantize_model_params_matches_jax(fmt):
    """The port's state_dict conversion gives the bytes the JAX package's
    param-tree conversion gives, carried across."""
    _, _, params = _dlrm_case(6)
    f32 = DLRM(5, 4, bottom_widths=(16, 32), top_widths=(32, 16, 1))
    f32.load_state_dict(load_flax_dlrm_params(jax.tree_util.tree_map(np.asarray, params)))
    got = quantize_model_params(f32.state_dict(), fmt)
    want = load_flax_dlrm_params(jqd.quantize_model_params(params, fmt))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(_bytes(got[k]), _bytes(want[k]))
    DLRM(5, 4, bottom_widths=(16, 32), top_widths=(32, 16, 1),
         quant_fmt=fmt).load_state_dict(got)


def jax_bf16_dlrm(params, dense, emb, fmt=None):
    """The Flax DLRM's forward with every dense product on bf16 operands and
    f32 accumulation, written out (what ``use_mixed_precision`` asks of
    XLA on a TPU)."""
    p = params["params"]

    def mlp(layers, x, final_activation):
        n = len(layers)
        for i in range(n):
            if fmt:
                layer = layers[f"QuantDense_{i}"]
                w = layer["kernel_q"].astype(jnp.float32) * layer["kernel_scale"][None, :]
            else:
                layer = layers[f"Dense_{i}"]
                w = layer["kernel"]
            x = jnp.dot(x.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                        preferred_element_type=jnp.float32) + layer["bias"]
            if i + 1 < n or final_activation:
                x = jax.nn.relu(x)
        return x

    bottom = mlp(p["MLP_0"], dense, True)
    x = FlaxDot().apply({}, bottom, emb)
    return mlp(p["MLP_1"], x, False).squeeze(-1)


@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
def test_mixed_precision_dlrm_matches_bf16_reference(monkeypatch, fmt):
    dense, emb, params = _dlrm_case(7)
    if fmt:
        params = jqd.quantize_model_params(params, fmt)
    monkeypatch.setenv("HPS_PALLAS_INTERPRET", "1")
    want = np.asarray(jax_bf16_dlrm(params, jnp.asarray(dense), jnp.asarray(emb), fmt))
    model = DLRM(5, 4, bottom_widths=(16, 32), top_widths=(32, 16, 1), quant_fmt=fmt)
    model.load_state_dict(load_flax_dlrm_params(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = model(torch.from_numpy(dense), torch.from_numpy(emb),
                    mixed_precision=True).numpy()
        f32 = model(torch.from_numpy(dense), torch.from_numpy(emb)).numpy()
    _logits_close(got, want)
    assert not np.array_equal(got, f32)  # the switch does round the operands


def _w8a8_479(seed, n=1024):
    """A w8a8 QuantDense(479, n) on a drawn weight, and its state_dict."""
    rng = np.random.default_rng(seed)
    state = _layer_state(_flax_layer(rng, 479, n, "w8a8"))
    layer = QuantDense(479, n, "w8a8", activation="relu")
    layer.load_state_dict(state)
    return layer, state


@pytest.mark.parametrize("arrives", ["load_state_dict", "assignment", "to",
                                     "quantize_model_params"])
def test_w8a8_rows_padded_for_k5(arrives):
    """Queue C: the w8a8 layer keeps ``kernel_q`` as the [N, K] view of rows
    zero-padded to 16 bytes and hands K5 those rows, so that at 479 -> 1024
    ``k5_plan`` picks ``wgmma`` (``narrow`` for [N, K] rows); the state_dict
    keeps [N, K]; the output is bit-equal to the plain version on the
    unpadded weight; the layer holds the weight once (K5's rows are
    ``kernel_q``'s storage) however it arrives, except a ``kernel_q``
    assigned in another layout, which is padded at each call."""
    from hugectr_backend_tpu_torch.ops.quant_matmul import _wvec, k5_plan, w8a8_dense_plain

    layer, state = _w8a8_479(20)
    if arrives == "assignment":
        layer.kernel_q = state["kernel_q"].contiguous().clone()
    elif arrives == "to":  # what .to(device) does: every buffer replaced
        old = layer.k5_weight()
        layer = layer._apply(lambda t: t.clone())
        assert layer.k5_weight().data_ptr() != old.data_ptr()
    elif arrives == "quantize_model_params":
        f32 = DLRM(13, 26, bottom_widths=(16, 128), top_widths=(64, 1))
        f32.init_flax_(torch.Generator().manual_seed(21))
        model = DLRM(13, 26, bottom_widths=(16, 128), top_widths=(64, 1), quant_fmt="w8a8")
        model.load_state_dict(quantize_model_params(f32.state_dict(), "w8a8"))
        layer = model.top.layers[0]
        state = {k: v for k, v in layer.state_dict().items()}
    n = layer.kernel_q.shape[0]
    padded = layer.k5_weight()
    assert tuple(padded.shape) == (n, 480) and _wvec(padded)
    assert not padded[:, 479:].any() and torch.equal(padded[:, :479], state["kernel_q"])
    if n >= 256:
        assert k5_plan(4096, n, 479, wvec=_wvec(padded)).variant == "wgmma"
        assert k5_plan(4096, n, 479, wvec=_wvec(layer.kernel_q.contiguous())).variant == "narrow"
    assert {k: tuple(v.shape) for k, v in layer.state_dict().items()} == {
        "kernel_q": (n, 479), "kernel_scale": (n,), "bias": (n,)}
    x = torch.from_numpy(np.random.default_rng(22).standard_normal((32, 479)).astype(np.float32))
    want = w8a8_dense_plain(x, state["kernel_q"], state["kernel_scale"], state["bias"],
                            layer.activation)
    assert torch.equal(layer(x), want)
    one_copy = padded.data_ptr() == layer.kernel_q.data_ptr()
    assert one_copy == (arrives != "assignment")


@pytest.mark.parametrize("mode", ["autograd", "inference"])
def test_w8a8_padded_copy_never_stale(mode):
    """A second ``load_state_dict`` (an in-place copy into ``kernel_q``)
    changes the output, also for a layer made and reloaded under
    ``inference_mode`` (its buffers are inference tensors): K5 reads
    ``kernel_q``'s own storage, so no older copy can be served."""
    from hugectr_backend_tpu_torch.ops.quant_matmul import w8a8_dense_plain

    x = torch.from_numpy(np.random.default_rng(24).standard_normal((16, 479)).astype(np.float32))
    _, this = _w8a8_479(23)
    _, other = _w8a8_479(25)
    with torch.inference_mode(mode == "inference"):
        layer = QuantDense(479, 1024, "w8a8", activation="relu")
        layer.load_state_dict(this)
        first, rows = layer(x), layer.k5_weight().data_ptr()
        layer.load_state_dict(other)
        second = layer(x)
        assert layer.kernel_q.is_inference() == (mode == "inference")
    assert layer.k5_weight().data_ptr() == rows
    assert not torch.equal(first, second)
    assert torch.equal(second, w8a8_dense_plain(x, other["kernel_q"], other["kernel_scale"],
                                                other["bias"], "relu"))
