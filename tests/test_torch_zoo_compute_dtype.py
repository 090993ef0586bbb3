"""``compute_dtype`` on the nine zoo families of the PyTorch port (models/
dcn, wdl, deepfm, xdeepfm, ncf, mmoe, din, bst, two_tower) and their servers,
against the Flax models at ``compute_dtype=jnp.bfloat16`` on parameters
carried across (every Flax parameter is f32: ``param_dtype``). The tests run
on one torch thread (``one_torch_thread``).

The bar, from readings. The port at bf16 against Flax at bf16, this file's
shapes at batch 16, weights and inputs from eight seeds: eight families
equal Flax bit for bit, and DeepFM parts by at most 2.24e-7 of its largest
logit (its first-order and FM terms are f32 sums, added in another order).
The port at f32 on the same weights parts from Flax at bf16 by at least
1.58e-4 of the largest output (DeepFM), 7.6e-4 (WDL) and 1.9e-3 to 5.2e-3
(the other seven). ``BAR`` is 2^-20 (9.5e-7) of the largest output: four
times the largest reading, and 166 times below the smallest f32 gap, so
that the f32 model, and a cast moved (DIN's pooling in bf16, the softmax or
the L2 norm rounded once at the end), fail it
(``test_bar_rejects_another_precision``). The port reaches it by taking
Flax's roundings where a torch op would round otherwise: the softmax below
f32 (``models.dlrm.softmax``) and the two-tower's norm
(``models.dlrm.l2_normalize``).
- Servers: the same lookups on both sides (bit-identical, ``test_torch_zoo``
  and ``test_torch_pooled`` hold that). The JAX server compiles the lookups
  and the model into one XLA program, which drops some of the model's bf16
  roundings: on the CPU it parts from its own Flax model, run op by op on
  the same rows, by 5.3e-5 (DeepFM) to 1.9e-2 (BST) of the largest logit
  here, about as far as the f32 model does. So a port server is held within ``BAR`` of the Flax
  model run op by op on the rows it looked up, and no further from the JAX
  server than the JAX server is from that model, plus ``BAR``
  (``_served``). Retrieval likewise: the queries and the scores against
  the reference, the keys the reference's wherever its scores stand apart,
  and the JAX server's wherever its own scores stand apart by more than
  twice its spread.
- The sharded stacked server at P = 2 against the unsharded one: the same
  rows and the same model, so the same bar.
- f32, the default: bit for bit what the port computed before
  ``compute_dtype`` existed (the same operations written out here).
- ``use_mixed_precision`` with a bf16 model: bit for bit the model without
  it (its products take bf16 operands already).

Here every product sums in f32, as the JAX package's do. On the card the
port serves bf16 with PyTorch's default, under which cuBLAS may add a
split-K product's partial sums in bf16 (keeping f32 sums there cost DCN-v2's
cross layers 646 against 46 µs a product, PERF.md): chip_smoke's ``zoo``
phase holds the card's bf16 outputs to bars from the card's own readings.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

import jax
import jax.numpy as jnp

import hugectr_backend_tpu_torch.models as tmodels
from hugectr_backend_tpu import models as jmodels

from torch_examples_common import one_torch_thread  # noqa: F401  (fixture)

BF16 = torch.bfloat16
B, ND, D, S = 8, 4, 16, 6
D_BST = 64  # two heads of dk 32: sqrt(32) rounds to 5.65625 in bf16

# family: (Flax model of a compute dtype, the port's, the loader, the
# shapes of the inputs after dense [B, ND]; "len" is DIN / BST's seq_len)
FAMILIES = {
    "wdl": (lambda dt: jmodels.WideAndDeep(deep_widths=(32, 16, 1), compute_dtype=dt),
            lambda dt: tmodels.WideAndDeep(ND, 5, D, (32, 16, 1), compute_dtype=dt),
            tmodels.load_flax_wdl_params, [(3, 1), (5, D)]),
    "deepfm": (lambda dt: jmodels.DeepFM(deep_widths=(32, 1), compute_dtype=dt),
               lambda dt: tmodels.DeepFM(ND, 4, D, (32, 1), compute_dtype=dt),
               tmodels.load_flax_deepfm_params, [(4, 1), (4, D)]),
    "dcn": (lambda dt: jmodels.DCNv2(num_cross_layers=2, cross_rank=8, deep_widths=(32,),
                                     head_widths=(16, 1), compute_dtype=dt),
            lambda dt: tmodels.DCNv2(ND, 4, D, 2, 8, (32,), (16, 1), compute_dtype=dt),
            tmodels.load_flax_dcn_params, [(4, D)]),
    "xdeepfm": (lambda dt: jmodels.XDeepFM(cin_feature_maps=(6, 4), deep_widths=(32, 1),
                                           compute_dtype=dt),
                lambda dt: tmodels.XDeepFM(ND, 5, D, (6, 4), (32, 1), compute_dtype=dt),
                tmodels.load_flax_xdeepfm_params, [(5, D)]),
    "ncf": (lambda dt: jmodels.NCF(mlp_widths=(32, 16), compute_dtype=dt),
            lambda dt: tmodels.NCF(0, D, (32, 16), compute_dtype=dt),
            tmodels.load_flax_ncf_params, [(1, D), (1, D)]),
    "mmoe": (lambda dt: jmodels.MMoE(num_experts=3, num_tasks=2, expert_widths=(16, 8),
                                     tower_widths=(8, 1), compute_dtype=dt),
             lambda dt: tmodels.MMoE(ND, 4, D, 3, 2, (16, 8), (8, 1), compute_dtype=dt),
             tmodels.load_flax_mmoe_params, [(4, D)]),
    "din": (lambda dt: jmodels.DIN(mlp_widths=(32, 16, 1), att_hidden=16, compute_dtype=dt),
            lambda dt: tmodels.DIN(ND, D, (32, 16, 1), att_hidden=16, compute_dtype=dt),
            tmodels.load_flax_din_params, [(D,), (S, D), "len"]),
    "bst": (lambda dt: jmodels.BST(num_heads=2, num_layers=1, head_widths=(32, 16, 1),
                                   compute_dtype=dt),
            lambda dt: tmodels.BST(ND, D_BST, S, num_heads=2, num_layers=1,
                                   head_widths=(32, 16, 1), compute_dtype=dt),
            tmodels.load_flax_bst_params, [(D_BST,), (S, D_BST), "len"]),
    "two_tower": (lambda dt: jmodels.TwoTowerUser(widths=(32, D), compute_dtype=dt),
                  lambda dt: tmodels.TwoTowerUser(ND, 1, D, (32, D), compute_dtype=dt),
                  tmodels.load_flax_two_tower_params, [(1, D)]),
}


def _inputs(family, rng, b=B) -> list:
    """The family's inputs drawn from ``rng`` (numpy): dense [B, ND] (NCF:
    [B, 0]), then the embeddings, a unit normal each, and seq_len in [0, S]."""
    out = [rng.standard_normal((b, 0 if family == "ncf" else ND)).astype(np.float32)]
    for shape in FAMILIES[family][3]:
        if shape == "len":
            out.append(rng.integers(0, S + 1, b).astype(np.int32))
        else:
            out.append(rng.standard_normal((b, *shape)).astype(np.float32))
    return out


def _carried(family, jdt=jnp.bfloat16, tdt=BF16, seed=0):
    """(the Flax model at ``jdt``, its params, the port's model at ``tdt``
    with them carried across)."""
    jmodel, tmodel, load, _ = FAMILIES[family]
    fm = jmodel(jdt)
    params = fm.init(jax.random.PRNGKey(seed),
                     *[jnp.asarray(x) for x in _inputs(family, np.random.default_rng(0))])
    model = tmodel(tdt)
    model.load_state_dict(load(jax.tree_util.tree_map(np.asarray, params)))
    return fm, params, model.eval()


BAR = 2.0 ** -20  # of the largest output; the readings in the docstring


def _f32(a) -> np.ndarray:
    """A JAX or torch array of any float type as f32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _within(got, want, what=""):
    rel = _rel(got, want)
    assert rel <= BAR, (what, rel, BAR)


def _run(model, xs, **kw):
    with torch.no_grad():
        return model(*[torch.from_numpy(x) for x in xs], **kw)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_model_bf16_matches_flax(one_torch_thread, family):
    """Each family at bf16 against the Flax model at bf16, same weights and
    inputs: the output's dtype (f32 logits; the two-tower's bf16 queries)
    and ``BAR``."""
    fm, params, model = _carried(family, seed=1)
    xs = _inputs(family, np.random.default_rng(2), b=16)
    want = fm.apply(params, *[jnp.asarray(x) for x in xs])
    got = _run(model, xs)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    _within(got, want)


def _pool_in_bf16(self, target, seq, seq_len):
    """DIN's attention pool with the pooling moved to bf16."""
    b, s, d = seq.shape
    t = target[:, None, :].expand(b, s, d)
    score = self.mlp(torch.cat([t, seq, t - seq, t * seq], dim=-1)).float().squeeze(-1)
    mask = torch.arange(s)[None, :] < seq_len[:, None]
    w = torch.softmax(score.masked_fill(~mask, -1e9), dim=-1) * mask.float()
    return torch.einsum("bs,bsd->bd", w.to(BF16), seq.to(BF16)).float()


def _rounded_once(x, dim):
    return torch.softmax(x, dim=dim)


def _norm_rounded_once(q, eps=1e-9):
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + eps)


# name: (family, the port's model in f32, (module, attribute, replacement))
CONTROLS = {
    **{f"{f}_in_f32": (f, True, None) for f in FAMILIES},
    "din_pooling_in_bf16": ("din", False,
                            ("models.din", "DinAttentionPool.forward", _pool_in_bf16)),
    "mmoe_softmax_rounded_once": ("mmoe", False, ("models.mmoe", "softmax", _rounded_once)),
    "bst_softmax_rounded_once": ("bst", False, ("models.bst", "softmax", _rounded_once)),
    "two_tower_norm_rounded_once": ("two_tower", False,
                                    ("models.two_tower", "l2_normalize", _norm_rounded_once)),
}


@pytest.mark.parametrize("control", list(CONTROLS))
def test_bar_rejects_another_precision(one_torch_thread, monkeypatch, control):
    """``BAR`` tells the configured precision from another: on the inputs of
    ``test_model_bf16_matches_flax``, the port's model in f32, or at bf16
    with one step rounded otherwise than Flax rounds it, parts from the Flax
    model at bf16 by more than the bar."""
    import importlib

    family, in_f32, patch = CONTROLS[control]
    fm, params, model = _carried(family, seed=1)
    if in_f32:
        f32 = FAMILIES[family][1](torch.float32)
        f32.load_state_dict(model.state_dict())
        model = f32.eval()
    if patch is not None:
        module, name, fn = patch
        where = importlib.import_module(f"hugectr_backend_tpu_torch.{module}")
        *outer, name = name.split(".")
        for part in outer:
            where = getattr(where, part)
        monkeypatch.setattr(where, name, fn)
    xs = _inputs(family, np.random.default_rng(2), b=16)
    assert _rel(_run(model, xs), fm.apply(params, *[jnp.asarray(x) for x in xs])) > BAR


# -- f32: the forward the port computed before compute_dtype ----------------


def _mlp(mlp, x):
    for layer, act in zip(mlp.layers, mlp.acts):
        x = F.linear(x, layer.weight, layer.bias)
        x = F.relu(x) if act else x
    return x


def _wdl(m, dense, wide, deep):
    b = dense.shape[0]
    return (wide.reshape(b, -1).sum(dim=1)
            + _mlp(m.deep, torch.cat([dense, deep.reshape(b, -1)], dim=1)).squeeze(-1))


def _deepfm(m, dense, first, emb):
    b = dense.shape[0]
    s = emb.sum(dim=1)
    fm = 0.5 * (s * s - (emb * emb).sum(dim=1)).sum(dim=1)
    deep = _mlp(m.deep, torch.cat([dense, emb.reshape(b, -1)], dim=1)).squeeze(-1)
    return first.reshape(b, -1).sum(dim=1) + fm + deep


def _dcn(m, dense, emb):
    x0 = torch.cat([dense, emb.reshape(emb.shape[0], -1)], dim=1)
    x = x0
    for c in m.cross:
        x = x0 * F.linear(F.linear(x, c.u.weight, c.u.bias), c.v.weight, c.v.bias) + x
    return _mlp(m.head, torch.cat([x, _mlp(m.deep, x0)], dim=1)).squeeze(-1)


def _xdeepfm(m, dense, emb):
    b, t, d = emb.shape
    x, pools = emb, []
    for c in m.cin:
        z = (x[:, :, None, :] * emb[:, None, :, :]).reshape(b, x.shape[1] * t, d)
        x = torch.matmul(c.w, z)
        pools.append(x.sum(dim=2))
    cin = F.linear(torch.cat(pools, dim=1), m.cin_head.weight, m.cin_head.bias)
    return (cin + _mlp(m.deep, torch.cat([dense, emb.reshape(b, -1)], dim=1))).squeeze(-1)


def _ncf(m, dense, u, v):
    b = u.shape[0]
    u, v = u.reshape(b, -1), v.reshape(b, -1)
    mlp = _mlp(m.mlp, torch.cat([dense, u, v], dim=1))
    return F.linear(torch.cat([u * v, mlp], dim=1), m.head.weight, m.head.bias).squeeze(-1)


def _mmoe(m, dense, emb):
    b = emb.shape[0]
    x = torch.cat([emb.reshape(b, -1), dense], dim=1)
    h = F.relu(F.linear(x, m.experts_in.weight, m.experts_in.bias)).view(b, m.num_experts, -1)
    for k, bias in zip(m.expert_kernels, m.expert_biases):
        h = F.relu(torch.einsum("beh,ehw->bew", h, k) + bias[None])
    gates = F.linear(x, m.gates.weight, m.gates.bias).view(b, m.num_tasks, m.num_experts)
    mixed = torch.einsum("bke,bew->bkw", torch.softmax(gates, dim=-1), h)
    return torch.cat([_mlp(t, mixed[:, i]) for i, t in enumerate(m.towers)], dim=1)


def _din(m, dense, target, seq, seq_len):
    b, s, d = seq.shape
    t = target[:, None, :].expand(b, s, d)
    score = _mlp(m.attention.mlp, torch.cat([t, seq, t - seq, t * seq], dim=-1)).squeeze(-1)
    mask = torch.arange(s)[None, :] < seq_len[:, None]
    w = torch.softmax(score.masked_fill(~mask, -1e9), dim=-1) * mask.float()
    pooled = torch.einsum("bs,bsd->bd", w, seq)
    return _mlp(m.mlp, torch.cat([dense, target, pooled], dim=1)).squeeze(-1)


def _bst(m, dense, target, seq, seq_len):
    b, s, d = seq.shape
    x = torch.cat([seq, target[:, None, :]], dim=1) + m.pos_emb[None]
    live = torch.cat([torch.arange(s)[None, :] < seq_len[:, None],
                      torch.ones((b, 1), dtype=torch.bool)], dim=1)
    for blk in m.blocks:
        h, t = blk.num_heads, s + 1
        q, k, v = (F.linear(x, lin.weight, lin.bias).view(b, t, h, d // h).transpose(1, 2)
                   for lin in (blk.q, blk.k, blk.v))
        logits = torch.matmul(q, k.transpose(-1, -2)) / float(np.sqrt(d // h))
        logits = logits.masked_fill(~live[:, None, None, :], -1e9)
        ctx = torch.matmul(torch.softmax(logits, dim=-1), v).transpose(1, 2).reshape(b, t, d)
        x = blk.norm1(x + F.linear(ctx, blk.o.weight, blk.o.bias))
        ff = F.linear(F.relu(F.linear(x, blk.ff1.weight, blk.ff1.bias)), blk.ff2.weight,
                      blk.ff2.bias)
        x = blk.norm2(x + ff)
    mk = live.float()[..., None]
    pooled = (x * mk).sum(dim=1) / mk.sum(dim=1)
    return _mlp(m.head, torch.cat([pooled, dense], dim=1)).squeeze(-1)


def _two_tower(m, dense, user):
    q = _mlp(m.mlp, torch.cat([user.reshape(user.shape[0], -1), dense], dim=1))
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-9)


F32_BEFORE = {"wdl": _wdl, "deepfm": _deepfm, "dcn": _dcn, "xdeepfm": _xdeepfm, "ncf": _ncf,
              "mmoe": _mmoe, "din": _din, "bst": _bst, "two_tower": _two_tower}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_f32_default_is_bit_for_bit_what_it_was(one_torch_thread, family):
    _, params, default = _carried(family, jnp.float32, torch.float32, seed=3)
    explicit = FAMILIES[family][1](torch.float32)
    explicit.load_state_dict(default.state_dict())
    xs = [torch.from_numpy(x) for x in _inputs(family, np.random.default_rng(4))]
    with torch.no_grad():
        want = F32_BEFORE[family](default, *xs)
        for m in (default, explicit.eval()):
            got = m(*xs)
            assert got.dtype == torch.float32 and torch.equal(got, want)


# -- the types at each step, where the families part from "all in bf16" -----


class _Ops(TorchFunctionMode):
    """Records (name, output) of every torch function a forward calls."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor):
            self.ops.append((getattr(func, "__name__", str(func)), out))
        return out

    def of(self, name) -> list:
        return [t for n, t in self.ops if n == name]


def _jax_ops(fm, params, xs) -> list:
    """(primitive name, output dtype) of each equation of the Flax model's
    forward, nested jaxprs included, in order."""
    out = []

    def walk(jaxpr):
        for e in jaxpr.eqns:
            out.append((e.primitive.name, e.outvars[0].aval.dtype))
            for p in e.params.values():
                for sub in p if isinstance(p, (tuple, list)) else (p,):
                    sub = getattr(sub, "jaxpr", sub)
                    if hasattr(sub, "eqns"):
                        walk(sub)

    walk(jax.make_jaxpr(lambda p, *a: fm.apply(p, *a))(params, *xs).jaxpr)
    return out


def _traced(family, seed=5):
    """(the Flax model's intermediates, its jaxpr's ops, its output, the
    port's ops, its output, module outputs by name), one input."""
    fm, params, model = _carried(family, seed=seed)
    xs = _inputs(family, np.random.default_rng(seed))
    jx = [jnp.asarray(x) for x in xs]
    want, inter = fm.apply(params, *jx, capture_intermediates=True,
                           mutable=["intermediates"])
    mods = {}
    for name, mod in model.named_modules():
        mod.register_forward_hook(lambda m, a, o, name=name: mods.setdefault(name, o))
    with _Ops() as ops:
        got = _run(model, xs)
    return inter["intermediates"], _jax_ops(fm, params, jx), want, ops, got, mods, model


def test_xdeepfm_cin_layers_f32_and_bf16_final_sum(one_torch_thread):
    """Each CIN layer returns f32 (the next layer's ``x``); the head and the
    deep MLP give bf16, summed in bf16 before the f32 cast, on both sides."""
    inter, _, want, _, got, mods, model = _traced("xdeepfm")
    for i in range(2):
        assert inter[f"CINLayer_{i}"]["__call__"][0].dtype == jnp.float32
        assert mods[f"cin.{i}"].dtype == torch.float32
    j_cin, j_deep = inter["Dense_0"]["__call__"][0], inter["MLP_0"]["__call__"][0]
    assert j_cin.dtype == j_deep.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_f32(want), _f32((j_cin + j_deep).astype(jnp.float32))[:, 0])
    from hugectr_backend_tpu_torch.models.dlrm import dense

    pools = torch.cat([mods[f"cin.{i}"].sum(dim=2) for i in range(2)], dim=1)
    with torch.no_grad():
        cin = dense(pools, model.cin_head, compute_dtype=BF16)
    deep = mods["deep"]
    assert cin.dtype == deep.dtype == BF16
    assert torch.equal(got, (cin + deep).float().squeeze(-1))
    _within(cin, j_cin, "the CIN head")


def test_mmoe_concat_promotes_to_f32(one_torch_thread):
    """``[flat emb (f32); dense cast to bf16]`` is f32 on both sides (then
    cast to bf16); the experts, the gates' softmax, the mixture and the
    towers run in bf16; the task logits are concatenated in bf16."""
    inter, jops, _, ops, got, mods, _ = _traced("mmoe")
    cats = [dt for name, dt in jops if name == "concatenate"]
    assert cats == [jnp.float32, jnp.bfloat16]
    assert [t.dtype for t in ops.of("cat")] == [torch.float32, BF16]
    assert [t.dtype for t in ops.of("exp")] == [BF16]
    assert [dt for name, dt in jops if name == "exp"] == [jnp.bfloat16]
    for t in range(2):
        assert inter[f"MLP_{t}"]["__call__"][0].dtype == jnp.bfloat16
        assert mods[f"towers.{t}"].dtype == BF16
    assert inter["experts_in"]["__call__"][0].dtype == jnp.bfloat16
    assert got.dtype == torch.float32


def test_bst_sqrt_dk_and_mask_in_bf16(one_torch_thread):
    """The logits are divided by sqrt of a bf16 dk (5.65625 for dk 32, not
    5.656854) and the dead keys masked with -1e9 in bf16 (-998,244,352);
    the softmax's exponentials, each LayerNorm's output and the block run
    in bf16."""
    inter, jops, _, ops, _, mods, _ = _traced("bst")
    assert [dt for name, dt in jops if name == "sqrt"] == [jnp.bfloat16]
    assert [dt for name, dt in jops if name == "select_n"] == [jnp.bfloat16]
    neg = float(jnp.asarray(-1e9, jnp.bfloat16))
    assert neg == -998244352.0
    (root,) = ops.of("sqrt")
    assert root.dtype == BF16 and float(root) == 5.65625
    (masked,) = ops.of("masked_fill")
    assert masked.dtype == BF16 and float(masked.float().min()) == neg
    assert [t.dtype for t in ops.of("exp")] == [BF16]
    assert [dt for name, dt in jops if name == "exp"] == [jnp.bfloat16]
    block = inter["_EncoderBlock_0"]
    for i in range(2):
        assert block[f"LayerNorm_{i}"]["__call__"][0].dtype == jnp.bfloat16
    assert mods["blocks.0"].dtype == BF16 and mods["head"].dtype == BF16


def test_two_tower_queries_in_bf16(one_torch_thread):
    """``[user rows (f32); dense cast to bf16]`` promotes to f32, the MLP
    casts it, the squares are summed in f32 (as XLA compiles
    ``jnp.linalg.norm``), the root and the quotient run in bf16 and q comes
    back bf16."""
    inter, jops, want, ops, got, mods, _ = _traced("two_tower")
    assert [dt for name, dt in jops if name == "concatenate"] == [jnp.float32]
    assert [t.dtype for t in ops.of("cat")] == [torch.float32]
    assert inter["MLP_0"]["__call__"][0].dtype == jnp.bfloat16 and mods["mlp"].dtype == BF16
    assert want.dtype == jnp.bfloat16 and got.dtype == BF16
    assert [t.dtype for t in ops.of("sum")] == [torch.float32]
    assert [dt for name, dt in jops if name == "reduce_sum"] == [jnp.float32]
    assert [t.dtype for t in ops.of("sqrt")] == [BF16]
    assert [dt for name, dt in jops if name in ("sqrt", "div")] == [jnp.bfloat16] * 2
    _within(got, want)


def test_din_scores_and_pooling_in_f32(one_torch_thread):
    """The attention MLP runs in bf16 and its score comes back f32: the mask,
    the softmax and the pooling run in f32, and the head MLP casts its f32
    input ``[dense; target; pooled]`` and gives bf16, on both sides."""
    inter, jops, want, ops, got, mods, _ = _traced("din")
    pool = inter["DinAttentionPool_0"]
    assert pool["MLP_0"]["__call__"][0].dtype == jnp.bfloat16
    assert mods["attention.mlp"].dtype == BF16
    assert [dt for name, dt in jops if name in ("exp", "select_n")] == [jnp.float32] * 2
    assert [t.dtype for t in ops.of("masked_fill")] == [torch.float32]
    assert [t.dtype for t in ops.of("softmax")] == [torch.float32]
    assert pool["__call__"][0].dtype == jnp.float32
    assert [t.dtype for t in ops.of("einsum")] == [torch.float32]
    assert mods["attention"].dtype == torch.float32
    assert [dt for name, dt in jops if name == "concatenate"] == [jnp.float32] * 2
    assert [t.dtype for t in ops.of("cat")] == [torch.float32] * 2
    assert inter["MLP_0"]["__call__"][0].dtype == jnp.bfloat16 and mods["mlp"].dtype == BF16
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _within(got, want)


MIXED = ("wdl", "deepfm", "dcn", "xdeepfm", "ncf", "mmoe")


@pytest.mark.parametrize("family", MIXED)
def test_mixed_precision_is_a_no_op_at_bf16(one_torch_thread, family):
    """``use_mixed_precision`` rounds f32 operands to bf16: a bf16 model's
    products have nothing left to round."""
    _, _, model = _carried(family, seed=6)
    xs = _inputs(family, np.random.default_rng(6))
    assert torch.equal(_run(model, xs, mixed_precision=True), _run(model, xs))


# -- the servers, one ps.json in both packages ------------------------------

TABLES = {"w": (30, 1), "a": (200, D), "b": (300, D), "t64": (300, D_BST)}
# model: (tables, keys per sample, quant_bits)
DEPLOYED = {
    "wdl": (["w", "a"], [3, 5], 8), "deepfm": (["w", "a"], [4, 4], 8),
    "dcn": (["a", "b"], [1, 3], 8), "xdeepfm": (["a", "b"], [2, 3], 8),
    "ncf": (["a", "b"], [1, 1], 8), "mmoe": (["a", "b"], [1, 3], 8),
    "din": (["a", "b"], [1, S], 8), "bst": (["t64", "t64"], [1, S], 8),
    "tt32": (["a", "b"], [1, 1], 32), "tt8": (["a", "b"], [1, 1], 8),
}


@pytest.fixture(scope="module")
def deployed(tmp_path_factory):
    import hugectr_backend_tpu as jpkg
    import hugectr_backend_tpu_torch as tpkg
    from hugectr_backend_tpu.io.sparse_model import write_sparse_model
    from hugectr_backend_tpu.io.synthetic import make_synthetic_table

    root = tmp_path_factory.mktemp("zoo_bf16")
    tbls = {}
    for i, (name, (rows, dim)) in enumerate(TABLES.items()):
        tbls[name] = make_synthetic_table(rows, dim, seed=60 + i)
        write_sparse_model(root / name, tbls[name].keys, tbls[name].vectors)
    cfg = {"models": [{
        "model": model, "sparse_files": [str(root / t) for t in names],
        "embedding_vecsize_per_table": [TABLES[t][1] for t in names],
        "maxnum_catfeature_query_per_table_per_sample": kps,
        "gpucacheper": 1.0, "embedding_cache_type": "static", "quant_bits": bits,
    } for model, (names, kps, bits) in DEPLOYED.items()]}
    return (tbls, jpkg.HierParameterServer.create(cfg),
            tpkg.HierParameterServer.create(cfg, device="cpu"))


def _both(deployed, model):
    _, jps, tps = deployed
    return ((jps.get_model_params(model), jps.get_embedding_cache(model, 0)),
            (tps.get_model_params(model), tps.get_embedding_cache(model, 0)))


def _keys(tbls, model, rng, b=B, miss=True):
    """Keys per table [B, K_t]; with ``miss``, ~1 in 8 absent."""
    names, kps, _ = DEPLOYED[model]
    out = []
    for n, k in zip(names, kps):
        keys = tbls[n].keys[rng.integers(0, tbls[n].num_rows, (b, k))].copy()
        if miss:
            keys[rng.random((b, k)) < 0.125] = -7 - rng.integers(0, 1000)
        out.append(keys)
    return out


def _rows(tc, keys) -> list:
    """Each table's rows for ``keys`` [B, K_t] as the port's cache looks them
    up (the JAX cache's, bit for bit): [B, K_t, D] numpy each."""
    rows = tc.lookup([np.asarray(k).reshape(-1) for k in keys])
    return [r.numpy().reshape(*np.shape(k), -1) for r, k in zip(rows, keys)]


def _served(got, want, eager, what=""):
    """A port server's output ``got`` against the JAX server's ``want`` and
    the Flax model run op by op on the rows the servers looked up
    (``eager``): within ``BAR`` of ``eager``, and no further from ``want``
    than the JAX server is from ``eager`` (its one XLA program drops some of
    the model's bf16 roundings), plus ``BAR``."""
    _within(got, eager, what)
    got, want, eager = _f32(got), _f32(want), _f32(eager)
    scale = np.abs(eager).max()
    assert np.abs(got - want).max() <= np.abs(want - eager).max() + BAR * scale, what


# The JAX make_*_server assemble functions: the model's inputs from dense
# and each table's rows.
_STACKED = ("dcn", "xdeepfm", "mmoe")


@pytest.mark.parametrize("family", MIXED)
def test_model_server_bf16_matches_jax(one_torch_thread, deployed, family):
    """``make_<family>_server`` with a bf16 model against the JAX server with
    the bf16 Flax model: f32 logits, held by ``_served``."""
    import hugectr_backend_tpu.serving.program as jprog
    import hugectr_backend_tpu_torch.serving.program as tprog

    make = f"make_{family}_server"
    fm, params, model = _carried(family, seed=7)
    (jp, jc), (tp, tc) = _both(deployed, family)
    jsrv, tsrv = getattr(jprog, make)(jp, jc, fm, params), getattr(tprog, make)(tp, tc, model)
    rng = np.random.default_rng(8)
    for b in (B, 5):
        keys = _keys(deployed[0], family, rng, b)
        dense = rng.standard_normal((b, 0 if family == "ncf" else ND)).astype(np.float32)
        got = tsrv.predict(keys, dense)
        assert got.dtype == torch.float32
        rows = _rows(tc, keys)
        xs = [dense, np.concatenate(rows, axis=1)] if family in _STACKED else [dense, *rows]
        _served(got, jsrv.predict(keys, dense), fm.apply(params, *map(jnp.asarray, xs)), b)


@pytest.mark.parametrize("family", ["din", "bst"])
def test_fused_din_server_bf16_matches_jax(one_torch_thread, deployed, family):
    import hugectr_backend_tpu.serving.pooled as jpooled
    from hugectr_backend_tpu_torch.serving.pooled import FusedDinServer

    fm, params, model = _carried(family, seed=9)
    (jp, jc), (tp, tc) = _both(deployed, family)
    jsrv, tsrv = jpooled.FusedDinServer(jp, jc, fm, params), FusedDinServer(tp, tc, model)
    rng = np.random.default_rng(10)
    target, seq = _keys(deployed[0], family, rng)
    seq_len = rng.integers(0, S + 1, B).astype(np.int32)
    dense = rng.standard_normal((B, ND)).astype(np.float32)
    got = tsrv.predict(target.reshape(-1), seq, seq_len, dense)
    assert got.dtype == torch.float32
    t_rows, s_rows = _rows(tc, [target, seq])
    eager = fm.apply(params, *map(jnp.asarray, (dense, t_rows[:, 0], s_rows, seq_len)))
    _served(got, jsrv.predict(target.reshape(-1), seq, seq_len, dense), eager)


@pytest.mark.parametrize("corpus", ["tt32", "tt8"], ids=["f32_corpus", "int8_corpus"])
def test_retrieval_bf16_tower_matches_jax(one_torch_thread, deployed, corpus):
    """A bf16 two-tower over an f32 corpus (q upcast exactly, f32 scores)
    and an int8 one (bf16 operands, f32 sums), against the JAX server with
    the bf16 Flax tower. The port's queries are the Flax tower's run op by
    op on the looked-up user rows, within ``BAR``; its scores are those
    queries against the corpus (within ``BAR``), and no further from the
    JAX server's than the JAX server's are from that same reference at its
    own keys (its one XLA program drops some bf16 roundings of the tower),
    plus ``BAR``. The keys are the reference's top k at every position whose
    reference score stands further from both neighbours than 2 ``BAR`` (at
    least half the positions), and the JAX server's wherever its scores
    stand further apart than twice its own spread."""
    from hugectr_backend_tpu.serving.retrieval import RetrievalServer as JaxRetrieval
    from hugectr_backend_tpu_torch.serving.retrieval import RetrievalServer

    k = 8
    tbls = deployed[0]
    fm, params, model = _carried("two_tower", seed=11)
    (jp, jc), (tp, tc) = _both(deployed, corpus)
    jsrv = JaxRetrieval(jp, jc, fm, params, k=k + 1)
    tsrv = RetrievalServer(tp, tc, model, k=k)
    rng = np.random.default_rng(12)
    ukeys = _keys(tbls, corpus, rng, miss=False)[0]
    dense = rng.standard_normal((B, ND)).astype(np.float32)
    got_keys, got_scores = tsrv.retrieve(ukeys, dense)
    want_keys, want_scores = jsrv.retrieve(ukeys, dense)
    urows = tc.lookup([ukeys.reshape(-1), np.zeros(0, np.int64)])[0].numpy()
    xs = [dense, urows.reshape(B, 1, D)]
    q = _f32(fm.apply(params, *map(jnp.asarray, xs))).astype(np.float64)
    _within(_run(model, xs), q, "the queries")
    corpus_rows, iscales, _, item_keys, _ = tsrv._corpus()
    scores = q @ corpus_rows.numpy().astype(np.float64).T
    if iscales is not None:
        scores = scores * iscales.numpy()[None, :]
    slot = {int(key): i for i, key in enumerate(np.asarray(item_keys))}

    def reference(keys):
        return np.take_along_axis(scores, np.vectorize(slot.get)(keys), axis=1)

    _within(got_scores, reference(got_keys), "the port's scores")
    scale = np.abs(scores).max()
    spread = np.abs(want_scores - reference(want_keys)).max() + BAR * scale
    assert np.abs(got_scores - want_scores[:, :k]).max() <= spread
    ref_keys = np.asarray(item_keys)[np.argsort(-scores, axis=1, kind="stable")[:, : k + 1]]
    for keys, ref, gap, enough in ((ref_keys, reference(ref_keys), 2 * BAR * scale, 0.5),
                                   (want_keys, want_scores, 2 * spread, 0.0)):
        apart = np.abs(np.diff(ref, axis=1)) > gap
        sep = apart[:, :k].copy()
        sep[:, 1:] &= apart[:, : k - 1]
        assert not enough or sep.mean() > enough, sep.mean()
        np.testing.assert_array_equal(got_keys[sep], keys[:, :k][sep])


def test_sharded_stacked_server_bf16_matches_unsharded(one_torch_thread, deployed):
    """``make_sharded_stacked_server`` at P = 2 (one table axis on the CPU)
    with a bf16 DCN-v2 against ``make_dcn_server`` on the ps.json: the same
    rows and model, the DCN-v2 bar."""
    import copy

    import hugectr_backend_tpu_torch.serving.program as tprog
    from hugectr_backend_tpu_torch.parallel.fused_sharded import make_sharded_stacked_server
    from hugectr_backend_tpu_torch.parallel.mesh import make_mesh
    from hugectr_backend_tpu_torch.parallel.sharded_table import ShardedTable

    tbls = deployed[0]
    _, _, model = _carried("dcn", seed=13)
    _, (tp, tc) = _both(deployed, "dcn")
    mesh = make_mesh(table=2, devices=[torch.device("cpu")] * 2)
    names, kps, _ = DEPLOYED["dcn"]
    shards = [ShardedTable.from_numpy(tbls[n].keys, tbls[n].vectors, mesh) for n in names]
    sharded = make_sharded_stacked_server(mesh, shards, kps, copy.deepcopy(model))
    plain = tprog.make_dcn_server(tp, tc, model)
    rng = np.random.default_rng(14)
    for b in (B, 5):
        keys = _keys(tbls, "dcn", rng, b, miss=False)
        dense = rng.standard_normal((b, ND)).astype(np.float32)
        got = sharded.predict(keys, dense)
        assert got.dtype == torch.float32
        _within(got, plain.predict(keys, dense), b)


def test_microbench_zoo_dtypes_runs_on_the_cpu(one_torch_thread):
    """The dtype microbenchmark at a small size: every model and variant, no
    device time on the CPU; the bf16 forwards part from the f32 one (the
    same weights), and cuBLAS's switch changes nothing here. The pre-repair
    forms it swaps in for ``bf16`` and ``bf16_f32_sums`` are put back after
    each variant: ``bf16_f32_out`` is the model as it serves. The tensor
    cores' ``bf16_mm_out_dtype`` has no CPU kernel and runs on the card only."""
    from hugectr_backend_tpu_torch.models import DCNv2
    from hugectr_backend_tpu_torch.scripts import microbench_zoo_dtypes as mz

    lines = mz.run("cpu", dcn_batch=16, bst_batch=8, seq=4, emit=lambda line: None)
    assert [(ln["model"], ln["variant"]) for ln in lines] == [
        (m, v) for m in ("dcn_v2", "bst")
        for v in ("f32", "bf16", "bf16_f32_sums", "bf16_f32_out")]
    assert all("us" not in ln and ln["device"] == "cpu" for ln in lines)
    for model in ("dcn_v2", "bst"):
        rel = {ln["variant"]: ln["rel_vs_f32"] for ln in lines if ln["model"] == model}
        assert rel["f32"] == 0.0 and 0.0 < rel["bf16"] == rel["bf16_f32_sums"]
        assert 0.0 < rel["bf16_f32_out"]
    _, sets = mz.models(16, 8, 4, "cpu")[0][1:]
    f32 = DCNv2(13, 26, 128).init_flax_(torch.Generator().manual_seed(mz.SEED))
    bf16 = DCNv2(13, 26, 128, compute_dtype=BF16)
    bf16.load_state_dict(f32.state_dict())
    with torch.no_grad():
        want = f32(*sets[0])
        got = bf16(*sets[0])
    rel = {ln["variant"]: ln["rel_vs_f32"] for ln in lines if ln["model"] == "dcn_v2"}
    assert float((got.float() - want).abs().max() / want.abs().max()) == rel["bf16_f32_out"]
