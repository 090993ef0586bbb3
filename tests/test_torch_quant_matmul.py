"""K5 (the w8a8 dense layer) of the PyTorch port against the JAX package.

On the CPU the port's wrapper takes the plain version, ``w8a8_dense_plain``;
the CUDA kernel is held against that plain version on the card by
``chip_smoke.py``.

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

import jax.numpy as jnp

from hugectr_backend_tpu.models.quant_dense import quantize_activations as jax_quant_act
from hugectr_backend_tpu.ops.quant_matmul import w8a8_dense as jax_w8a8
from hugectr_backend_tpu.ops.quant_matmul import xla_w8a8
from hugectr_backend_tpu_torch.ops import kernels
from hugectr_backend_tpu_torch.ops.quant_matmul import (
    quantize_activations,
    w8a8_dense,
    w8a8_dense_plain,
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
