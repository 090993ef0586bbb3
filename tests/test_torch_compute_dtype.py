"""``compute_dtype`` of the PyTorch port (models/quant_dense.py, models/dlrm.py)
and the bf16 route of K2 / K3 / K4's plain versions, against the JAX
package's modules on parameters carried across (the Pallas bodies run with
``HPS_PALLAS_INTERPRET=1``).

Tolerances, each from the roundings the layer has:
- ``QuantDense`` w8a8: equal (K5's plain version is exact against the JAX
  formulation, and both cast the same f32 result to bf16).
- ``QuantDense`` int8 / fp8 weight-only: both dequantize the weights in bf16
  (one rounding of an exact product), multiply in f32 with f32 sums in
  their own orders and round the f32 result once to bf16: at most 1 bf16
  ulp.
- ``MLP`` layers (``nn.Linear`` in bf16), each fed the same bf16 input:
  Flax rounds the product to bf16 and then the bias add; the port's
  ``F.linear`` may round once. Both sit within half an ulp of the exact
  value at each rounding, so they differ by at most 2 ulp of the larger of
  the product and the output (|product| <= |output| + |bias|).
- K2 / K3 / K4 at bf16: the same bf16 z, f32 sums in another order, one
  rounding to bf16: at most 1 ulp; the bottom copy is exact.
- The whole bf16 DLRM: 2 ulp at each of its 8 dense layers plus 1 at the
  interaction, each at most 2^-7 relative, compounding into at most
  (1 + 2^-7)^17 - 1 = 0.142 of the largest logit; the test holds it to that.
- f32 (the default): bit for bit what the port computed before
  ``compute_dtype`` existed (the same operations written out).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from hugectr_backend_tpu.models import quant_dense as jqd
from hugectr_backend_tpu.models.dlrm import DLRM as FlaxDLRM
from hugectr_backend_tpu.models.dlrm import MLP as FlaxMLP
from hugectr_backend_tpu.ops import fused_interaction as jfi
from hugectr_backend_tpu_torch.models.dlrm import DLRM, MLP, load_flax_dlrm_params
from hugectr_backend_tpu_torch.models.quant_dense import QuantDense
from hugectr_backend_tpu_torch.ops import fused_interaction as tfi

from torch_examples_common import one_torch_thread  # noqa: F401  (fixture)

BF16 = torch.bfloat16
FMTS = ["int8", "fp8", "w8a8"]
DLRM_BAR = (1 + 2.0 ** -7) ** 17 - 1


def _bf16_np(a) -> np.ndarray:
    """A bf16 array (JAX or torch) as f32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _ulp(x: np.ndarray) -> np.ndarray:
    """The bf16 ulp at |x| (8 significant bits), the smallest normal's at 0."""
    m = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(m)) - 7).astype(np.float32)


def _within_ulps(got, want, n, scale=None):
    got, want = _bf16_np(got), _bf16_np(want)
    assert got.shape == want.shape
    ref = np.abs(want) if scale is None else np.maximum(np.abs(want), scale)
    err = np.abs(got - want)
    assert (err <= n * _ulp(ref)).all(), float((err / _ulp(ref)).max())


def _layer_state(p) -> dict:
    state = load_flax_dlrm_params({"MLP_0": {"QuantDense_0": p}, "MLP_1": {}})
    return {k[len("bottom.layers.0."):]: v for k, v in state.items()}


def _flax_layer(rng, k, n, fmt):
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    q, s = jqd.quantize_weight(w, fmt)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return {"kernel_q": jnp.asarray(q), "kernel_scale": jnp.asarray(s), "bias": jnp.asarray(b)}


@pytest.mark.parametrize("act", ["relu", None])
@pytest.mark.parametrize("fmt", FMTS)
def test_quant_dense_bf16_matches_flax(one_torch_thread, fmt, act):
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((16, 96)), jnp.bfloat16)
    p = _flax_layer(rng, 96, 40, fmt)
    want = jqd.QuantDense(40, fmt, jnp.bfloat16, activation=act).apply({"params": p}, x)
    assert want.dtype == jnp.bfloat16
    layer = QuantDense(96, 40, fmt, activation=act, compute_dtype=BF16)
    layer.load_state_dict(_layer_state(p))
    got = layer(torch.from_numpy(_bf16_np(x)).to(BF16))
    assert got.dtype == BF16
    if fmt == "w8a8":
        np.testing.assert_array_equal(_bf16_np(got), _bf16_np(want))
    else:
        _within_ulps(got, want, 1)


@pytest.mark.parametrize("final_activation", [True, False])
def test_mlp_bf16_layer_by_layer_matches_flax(one_torch_thread, final_activation):
    rng = np.random.default_rng(12)
    widths = (48, 32, 16)
    x = jnp.asarray(rng.standard_normal((24, 20)), jnp.float32)
    flax_mlp = FlaxMLP(widths, jnp.bfloat16, final_activation=final_activation)
    params = flax_mlp.init(jax.random.PRNGKey(3), x)["params"]
    mlp = MLP(20, widths, final_activation=final_activation, compute_dtype=BF16)
    state = load_flax_dlrm_params({"MLP_0": jax.tree_util.tree_map(np.asarray, params),
                                   "MLP_1": {}})
    mlp.load_state_dict({k[len("bottom."):]: v for k, v in state.items()})
    h = x.astype(jnp.bfloat16)
    for i, width in enumerate(widths):
        act = i + 1 < len(widths) or final_activation
        layer = FlaxMLP((width,), jnp.bfloat16, final_activation=act)
        want = layer.apply({"params": {"Dense_0": params[f"Dense_{i}"]}}, h)
        one = MLP(h.shape[1], (width,), final_activation=act, compute_dtype=BF16)
        one.layers[0].load_state_dict(mlp.layers[i].state_dict())
        got = one(torch.from_numpy(_bf16_np(h)).to(BF16))
        assert got.dtype == BF16 and want.dtype == jnp.bfloat16
        bias = np.abs(np.asarray(params[f"Dense_{i}"]["bias"], np.float32))
        _within_ulps(got, want, 2, scale=np.abs(_bf16_np(want)) + bias)
        h = want
    whole = mlp(torch.from_numpy(np.array(x)))
    assert whole.dtype == BF16 and whole.shape == (24, widths[-1])


def _interaction_inputs(b, seed, d=128):
    rng = np.random.default_rng(seed)
    bottom = rng.standard_normal((b, d)).astype(np.float32)
    parts = [rng.standard_normal((n, b + extra, d)).astype(np.float32)
             for n, extra in ((5, 3), (3, 0), (1, 8))]
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    tb = lambda a: torch.from_numpy(_bf16_np(bf(a))).to(BF16)  # noqa: E731
    return bottom, parts, bf, tb


@pytest.mark.parametrize("b", [8, 16])
@pytest.mark.parametrize("fmap", [((1, 2), (0, 0), (2, 0), (0, 3), (1, 0), (0, 1)),
                                  ((0, 0), (0, 1), (0, 2), (1, 0), (2, 0))],
                         ids=["general", "part_major"])
def test_k2_bf16_plain_vs_pallas(one_torch_thread, b, fmap):
    bottom, parts, bf, tb = _interaction_inputs(b, 20 + b)
    want = jfi.fused_dot_interaction_parts(bf(bottom), [bf(p) for p in parts], fmap, True)
    got = tfi.dot_interaction_parts(tb(bottom), [tb(p) for p in parts], fmap)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    np.testing.assert_array_equal(_bf16_np(got)[:, :128], _bf16_np(bf(bottom)))
    _within_ulps(got, want, 1)


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_k3_bf16_plain_vs_pallas(one_torch_thread, dtype):
    jdt, tdt = {"int8": (jnp.int8, torch.int8),
                "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}[dtype]
    b = 16
    rng = np.random.default_rng(30)
    bottom, parts, bf, tb = _interaction_inputs(b, 31)
    members = ((0, 128), (128, 256), (384, 128))
    raw = np.clip(np.rint(rng.standard_normal((512, 128)) * 40), -127, 127).astype(np.float32)
    slots = np.stack([rng.integers(o, o + s, b + 8) for o, s in members]).astype(np.int32)
    scales = (rng.random((3, b + 8)) * 0.05 + 0.001).astype(np.float32)
    used = (3, 1, 1)
    fmap = tuple((p, s) for p, n in enumerate(used) for s in range(n))
    want = jfi.fused_dot_interaction_oh_parts(
        bf(bottom), jnp.asarray(raw).astype(jdt), jnp.asarray(slots[:, :b]),
        jnp.asarray(scales[:, :b]), tuple(bf(p) for p in parts), members=members,
        interpret=True, part_rows=used)
    got = tfi.dot_interaction_oh_parts(
        tb(bottom), torch.from_numpy(raw).to(tdt), torch.from_numpy(slots),
        torch.from_numpy(scales), [tb(p) for p in parts], fmap, members)
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    _within_ulps(got, want, 1)


def test_k4_bf16_plain_vs_pallas(one_torch_thread):
    rng = np.random.default_rng(40)
    bottom = jnp.asarray(rng.standard_normal((16, 128)), jnp.bfloat16)
    emb = jnp.asarray(rng.standard_normal((16, 26, 128)), jnp.bfloat16)
    want = jfi.fused_dot_interaction(bottom, emb, True)
    got = tfi.fused_dot_interaction(torch.from_numpy(_bf16_np(bottom)).to(BF16),
                                    torch.from_numpy(_bf16_np(emb)).to(BF16))
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    _within_ulps(got, want, 1)


def _dlrm_case(seed, b=16, nd=5, tables=4, d=32):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((b, nd)).astype(np.float32)
    emb = rng.standard_normal((b, tables, d)).astype(np.float32)
    f32 = FlaxDLRM(bottom_widths=(16, d), top_widths=(32, 16, 1))
    params = f32.init(jax.random.PRNGKey(seed), jnp.zeros((b, nd)), jnp.zeros((b, tables, d)))
    return dense, emb, params


def _logits_within(got, want, bar):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= bar * np.abs(want).max(), (
        np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("fmt", [None, *FMTS])
def test_dlrm_bf16_matches_flax(one_torch_thread, monkeypatch, fmt):
    dense, emb, params = _dlrm_case(13)
    if fmt:
        params = jqd.quantize_model_params(params, fmt)
    monkeypatch.setenv("HPS_PALLAS_INTERPRET", "1")
    flax_model = FlaxDLRM(bottom_widths=(16, 32), top_widths=(32, 16, 1),
                          compute_dtype=jnp.bfloat16, quant_fmt=fmt)
    want = np.asarray(flax_model.apply(params, jnp.asarray(dense), jnp.asarray(emb)))
    model = DLRM(5, 4, bottom_widths=(16, 32), top_widths=(32, 16, 1), quant_fmt=fmt,
                 compute_dtype=BF16)
    model.load_state_dict(load_flax_dlrm_params(jax.tree_util.tree_map(np.asarray, params)))
    with torch.no_grad():
        got = model(torch.from_numpy(dense), torch.from_numpy(emb)).numpy()
    _logits_within(got, want, DLRM_BAR)


def test_dlrm_bf16_over_emb_parts_matches_flax(one_torch_thread, monkeypatch):
    """The serving shape of the input: chunked parts (K2) and a folded
    one-hot group (K3), cast to bf16 while the one-hot arena keeps int8."""
    b, d = 16, 128
    rng = np.random.default_rng(14)
    dense = rng.standard_normal((b, 5)).astype(np.float32)
    parts = [rng.standard_normal((2, b, d)).astype(np.float32),
             rng.standard_normal((1, b, d)).astype(np.float32)]
    fmap = ((0, 0), (0, 1), (1, 0))
    members = ((0, 128), (128, 128))
    arena = np.clip(np.rint(rng.standard_normal((256, d)) * 40), -127, 127).astype(np.int8)
    slots = np.stack([rng.integers(o, o + s, b) for o, s in members]).astype(np.int32)
    scales = (rng.random((2, b)) * 0.05 + 0.001).astype(np.float32)
    monkeypatch.setenv("HPS_PALLAS_INTERPRET", "1")
    for fold in (False, True):
        tables = len(fmap) + (len(members) if fold else 0)
        flax_model = FlaxDLRM(bottom_widths=(16, d), top_widths=(32, 1),
                              compute_dtype=jnp.bfloat16)
        params = flax_model.init(jax.random.PRNGKey(4), jnp.zeros((b, 5)),
                                 jnp.zeros((b, tables, d)))
        model = DLRM(5, tables, bottom_widths=(16, d), top_widths=(32, 1), compute_dtype=BF16)
        model.load_state_dict(load_flax_dlrm_params(jax.tree_util.tree_map(np.asarray, params)))
        j_oh = t_oh = None
        if fold:
            j_oh = (jnp.asarray(arena), jnp.asarray(slots), jnp.asarray(scales), members)
            t_oh = (torch.from_numpy(arena), torch.from_numpy(slots), torch.from_numpy(scales),
                    members)
        jemb = jfi.EmbParts([jnp.asarray(p) for p in parts], fmap, b, oh=j_oh)
        temb = tfi.EmbParts([torch.from_numpy(p) for p in parts], fmap, b, oh=t_oh)
        want = np.asarray(flax_model.apply(params, jnp.asarray(dense), jemb))
        with torch.no_grad():
            got = model(torch.from_numpy(dense), temb).numpy()
        _logits_within(got, want, DLRM_BAR)
        assert temb.parts[0].dtype == torch.float32  # the caller's parts are not cast


def test_emb_parts_astype_keeps_the_one_hot_group():
    oh = (torch.zeros(4, 8, dtype=torch.int8), torch.zeros(1, 2, dtype=torch.int32),
          torch.ones(1, 2), ((0, 4),))
    ep = tfi.EmbParts([torch.zeros(2, 2, 8)], ((0, 0), (0, 1)), 2, oh=oh)
    cast = ep.astype(BF16)
    assert cast.parts[0].dtype == BF16 and cast.oh is oh
    assert cast.shape == ep.shape == (2, 3, 8) and cast.feature_map == ep.feature_map


def _f32_forward(model, dense, emb):
    """The f32 DLRM as the port computed it before ``compute_dtype``: linear
    layers with their bias, relu, the plain interaction, the top MLP."""
    x = dense
    for i, layer in enumerate(model.bottom.layers):
        x = F.relu(F.linear(x, layer.weight, layer.bias))
    z = torch.stack([x] + list(emb.unbind(1)), dim=1).to(BF16).float()
    zzt = torch.bmm(z, z.transpose(1, 2))
    r, c = torch.triu_indices(z.shape[1], z.shape[1], 1)
    x = torch.cat([x, zzt[:, r, c]], dim=1)
    n = len(model.top.layers)
    for i, layer in enumerate(model.top.layers):
        x = F.linear(x, layer.weight, layer.bias)
        if i + 1 < n:
            x = F.relu(x)
    return x.squeeze(-1)


def test_f32_default_is_bit_for_bit_what_it_was(one_torch_thread):
    dense, emb, params = _dlrm_case(15)
    state = load_flax_dlrm_params(jax.tree_util.tree_map(np.asarray, params))
    default = DLRM(5, 4, bottom_widths=(16, 32), top_widths=(32, 16, 1))
    explicit = DLRM(5, 4, bottom_widths=(16, 32), top_widths=(32, 16, 1),
                    compute_dtype=torch.float32)
    default.load_state_dict(state)
    explicit.load_state_dict(state)
    d, e = torch.from_numpy(dense), torch.from_numpy(emb)
    with torch.no_grad():
        want = _f32_forward(default, d, e)
        for m in (default, explicit):
            got = m(d, e)
            assert got.dtype == torch.float32
            assert torch.equal(got, want)


@pytest.mark.parametrize("fmt", FMTS)
def test_quant_dense_f32_default_is_bit_for_bit_what_it_was(one_torch_thread, fmt):
    rng = np.random.default_rng(16)
    x = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))
    layer = QuantDense(64, 48, fmt, activation="relu")
    layer.load_state_dict(_layer_state(_flax_layer(rng, 64, 48, fmt)))
    got = layer(x)
    if fmt == "w8a8":
        from hugectr_backend_tpu_torch.ops.quant_matmul import w8a8_dense

        want = w8a8_dense(x, layer.kernel_q, layer.kernel_scale, layer.bias, "relu")
    else:
        want = F.relu(F.linear(x, layer.kernel_q.float() * layer.kernel_scale[:, None])
                      + layer.bias)
    assert got.dtype == torch.float32 and torch.equal(got, want)
