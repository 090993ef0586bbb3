"""The training path of the PyTorch port against the JAX package: K4 (the
stacked dot interaction) forward and backward, the gradient of the chunked
interaction (K2), the DLRM loss and its gradients, Adam steps of
``train_dlrm``, and ``DLRM.init_flax_``.

The JAX side runs with ``HPS_PALLAS_INTERPRET=1`` (the Pallas bodies in
interpret mode: z rounded to bf16, f32 sums) at batches that are multiples
of 8; without it, or at a ragged batch, the JAX package takes its XLA
formulation, whose z is not rounded. Both backwards are the JAX package's
custom VJP: the pair gradients times the f32 z, summed in f32.

Tolerances:
- K4 forward: rtol 1e-5, atol 1e-6 * max|z|^2 (the same bf16 products,
  summed in another f32 order).
- interaction gradients: rtol 1e-5, atol 1e-6 * F * max|g| * max|z| (a sum
  of F f32 products in another order; g itself comes from the forward).
- DLRM loss and gradients: rtol 1e-4, and atol 1e-5 * max|grad| per tensor
  for the entries that cancel to near zero (f32 MLPs and the interaction
  summed in other orders).
- five Adam steps: losses rtol 1e-4; parameters and table atol 1e-5 + rtol
  1e-4. Adam divides by sqrt(v) + 1e-8, so a gradient entry near 1e-8 turns a
  rounding difference into a sizeable step: the test's seed and batch are
  chosen so that every gradient entry of the five steps is exactly zero (on
  both sides) or above 1e-7, and it asserts so.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from hugectr_backend_tpu.eval import auc_parity as jap
from hugectr_backend_tpu.models.dlrm import DLRM as FlaxDLRM
from hugectr_backend_tpu.ops import fused_interaction as jfi
from hugectr_backend_tpu_torch.eval import auc_parity as tap
from hugectr_backend_tpu_torch.models.dlrm import DLRM, load_flax_dlrm_params
from hugectr_backend_tpu_torch.ops import fused_interaction as tfi


def _zmax(*arrays) -> float:
    return max(float(np.abs(np.asarray(a, np.float32)).max()) for a in arrays)


def _carry(params) -> dict:
    return load_flax_dlrm_params(jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("b, t, d", [(8, 1, 16), (16, 5, 36), (8, 26, 128)])
def test_k4_forward_matches_pallas(b, t, d):
    rng = np.random.default_rng(b * t + d)
    bottom = rng.standard_normal((b, d)).astype(np.float32)
    emb = rng.standard_normal((b, t, d)).astype(np.float32)
    want = np.asarray(jfi.fused_dot_interaction(jnp.asarray(bottom), jnp.asarray(emb), True))
    got = tfi.fused_dot_interaction(torch.from_numpy(bottom), torch.from_numpy(emb))
    assert got.shape == want.shape == (b, d + (t + 1) * t // 2)
    np.testing.assert_array_equal(got[:, :d].numpy(), bottom)
    zm = _zmax(jnp.asarray(np.concatenate([bottom, emb.reshape(-1, d)])).astype(jnp.bfloat16))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * zm * zm)
    np.testing.assert_array_equal(
        got.numpy(), tfi.fused_dot_interaction_ref(torch.from_numpy(bottom),
                                                   torch.from_numpy(emb)).numpy())


def _assert_grad(got, want, feats, g, z):
    atol = 1e-6 * feats * _zmax(g) * _zmax(*z)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("b, t, d", [(8, 3, 16), (16, 26, 128)])
def test_k4_gradients_match_jax(b, t, d):
    """d/d(bottom, emb) of sum(out^2) through K4 against jax.grad of the
    interpreted Pallas K4 (its custom VJP)."""
    rng = np.random.default_rng(7 + b + t)
    bottom = rng.standard_normal((b, d)).astype(np.float32)
    emb = rng.standard_normal((b, t, d)).astype(np.float32)
    jg_b, jg_e = jax.grad(
        lambda x, e: jnp.sum(jfi.fused_dot_interaction(x, e, True) ** 2), argnums=(0, 1)
    )(jnp.asarray(bottom), jnp.asarray(emb))
    tb = torch.from_numpy(bottom).requires_grad_()
    te = torch.from_numpy(emb).requires_grad_()
    out = tfi.fused_dot_interaction(tb, te)
    (out ** 2).sum().backward()
    g = 2 * out.detach().numpy()
    _assert_grad(tb.grad.numpy(), np.asarray(jg_b), t + 1, g, [bottom, emb])
    _assert_grad(te.grad.numpy(), np.asarray(jg_e), t + 1, g, [bottom, emb])
    # The backward wrapper takes its plain version on the CPU, and the
    # Function's gradient is that wrapper's.
    args = (torch.from_numpy(bottom), torch.from_numpy(emb), torch.from_numpy(g))
    for fn in (tfi.fused_dot_interaction_bwd, tfi.fused_dot_interaction_bwd_ref):
        got_b, got_e = fn(*args)
        np.testing.assert_array_equal(tb.grad.numpy(), got_b.numpy())
        np.testing.assert_array_equal(te.grad.numpy(), got_e.numpy())


def test_k4_backward_uses_f32_z():
    """The backward multiplies by the f32 z, not the forward's bf16 z: with
    emb values that bf16 cannot hold, g_emb differs from a bf16-z product."""
    bottom = torch.full((8, 4), 1.0 + 2.0 ** -12)
    emb = torch.full((8, 1, 4), 1.0 + 2.0 ** -12)
    g = torch.zeros(8, 5)
    g[:, 4] = 1.0  # d loss / d (bottom . emb)
    g_bot, g_emb = tfi.fused_dot_interaction_bwd_ref(bottom, emb, g)
    assert torch.equal(g_emb[:, 0], bottom)  # not bf16(bottom) = 1.0
    assert torch.equal(g_bot, emb[:, 0])


PART_SHAPES = ((5, 3), (3, 0), (1, 8))  # (rows, phantom tail rows beyond B)
GENERAL = ((1, 2), (0, 0), (2, 0), (0, 3), (1, 0), (0, 1))  # leaves (0, 2), (0, 4), (1, 1) unmapped


@pytest.mark.parametrize("b, d", [(8, 16), (16, 128)])
def test_parts_gradients_match_jax(b, d):
    """The chunked interaction (K2) with phantom rows and unmapped subs:
    gradients of every part against jax.grad of the interpreted Pallas
    body; unmapped subs and rows past the batch get exactly zero."""
    rng = np.random.default_rng(b + d)
    bottom = rng.standard_normal((b, d)).astype(np.float32)
    parts = [rng.standard_normal((n, b + extra, d)).astype(np.float32)
             for n, extra in PART_SHAPES]
    jgrads = jax.grad(
        lambda x, ps: jnp.sum(jfi.fused_dot_interaction_parts(x, ps, GENERAL, True) ** 2),
        argnums=(0, 1),
    )(jnp.asarray(bottom), [jnp.asarray(p) for p in parts])
    tb = torch.from_numpy(bottom).requires_grad_()
    tps = [torch.from_numpy(p).requires_grad_() for p in parts]
    out = tfi.dot_interaction_parts(tb, tps, GENERAL)
    (out ** 2).sum().backward()
    g = 2 * out.detach().numpy()
    feats = len(GENERAL) + 1
    z = [bottom] + [parts[p][s][:b] for p, s in GENERAL]
    _assert_grad(tb.grad.numpy(), np.asarray(jgrads[0]), feats, g, z)
    for i, (tp, jgp) in enumerate(zip(tps, jgrads[1])):
        assert tp.grad.shape == tp.shape
        _assert_grad(tp.grad.numpy(), np.asarray(jgp), feats, g, z)
        assert not tp.grad[:, b:].any()  # phantom rows
        for s in range(tp.shape[0]):
            if (i, s) not in GENERAL:
                assert not tp.grad[s].any()


def test_forward_only_kernels_raise_under_autograd():
    """K3 and K5 have no backward: under autograd they raise instead of
    handing back a result cut from the graph; without it they run."""
    from hugectr_backend_tpu_torch.ops.quant_matmul import w8a8_dense

    bottom = torch.randn(8, 16, requires_grad=True)
    parts = [torch.randn(2, 8, 16)]
    arena = torch.randn(10, 16)
    slots = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="forward-only"):
        tfi.dot_interaction_oh_parts(bottom, arena, slots, None, parts, ((0, 0),))
    x = torch.randn(4, 16, requires_grad=True)
    wq = torch.randint(-127, 128, (8, 16), dtype=torch.int8)
    with pytest.raises(RuntimeError, match="forward-only"):
        w8a8_dense(x, wq, torch.rand(8), None, "relu")
    with torch.no_grad():
        assert tfi.dot_interaction_oh_parts(bottom, arena, slots, None, parts,
                                            ((0, 0),)).shape == (8, 16 + 3)
        assert w8a8_dense(x, wq, torch.rand(8), None, "relu").shape == (4, 8)


# ------------------------------------------------------------ DLRM training

ND = 13


def _flax_init(seed, nf, dim, bottom, top, vocab):
    """The initial state of the JAX package's train_dlrm (its lines
    131-140)."""
    model = FlaxDLRM(bottom_widths=(*bottom, dim), top_widths=top)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((2, ND), jnp.float32),
                        jnp.zeros((2, nf, dim), jnp.float32))
    table = 0.05 * jax.random.normal(jax.random.PRNGKey(seed + 1), (vocab, dim), jnp.float32)
    return model, params, table


def _jax_loss_fn(model, kidx, dense, labels):
    def loss_fn(pt):
        p, t = pt
        logits = model.apply(p, dense, jnp.take(t, kidx, axis=0))
        return optax.sigmoid_binary_cross_entropy(logits, labels).mean()
    return loss_fn


def _close_grads(got: dict, want: dict):
    for name, w in want.items():
        g = got[name]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_dlrm_loss_and_gradients_match_jax(monkeypatch):
    monkeypatch.setenv("HPS_PALLAS_INTERPRET", "1")
    b, nf, dim, vocab = 64, 6, 16, 200
    model, params, table = _flax_init(3, nf, dim, (32,), (64, 32, 1), vocab)
    data = tap.make_click_dataset(b, vocab, num_feats=nf, seed=3)
    jloss, (jgp, jgt) = jax.value_and_grad(_jax_loss_fn(
        model, jnp.asarray(data.keys_idx), jnp.asarray(data.dense),
        jnp.asarray(data.labels)))((params, table))

    tmodel = DLRM(ND, nf, (32, dim), (64, 32, 1))
    tmodel.load_state_dict(_carry(params))
    ttable = torch.tensor(np.asarray(table), requires_grad=True)
    loss = tap.dlrm_loss(tmodel, ttable, torch.from_numpy(data.keys_idx).long(),
                         torch.from_numpy(data.dense), torch.from_numpy(data.labels))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-4)
    want = _carry(jgp)
    _close_grads({n: p.grad.numpy() for n, p in tmodel.named_parameters()},
                 {n: w.numpy() for n, w in want.items()})
    _close_grads({"table": ttable.grad.numpy()}, {"table": np.asarray(jgt)})


STEP_CFG = dict(dim=8, batch=64, lr=5e-3, seed=19, bottom_widths=(16,), top_widths=(16, 1))
STEP_DATA = dict(n_samples=512, vocab=40, num_feats=4, seed=19)


def _jax_steps(data, steps):
    """train_dlrm's own loop, written out to read each step's loss and
    gradients: -> (losses, the smallest nonzero |gradient| entry, params,
    table)."""
    c = STEP_CFG
    model, params, table = _flax_init(c["seed"], data.keys_idx.shape[1], c["dim"],
                                      c["bottom_widths"], c["top_widths"], len(data.key_ids))
    opt = optax.adam(c["lr"])
    opt_state = opt.init((params, table))

    @jax.jit
    def step(params, table, opt_state, kidx, dense, labels):
        loss, grads = jax.value_and_grad(_jax_loss_fn(model, kidx, dense, labels))((params, table))
        updates, opt_state = opt.update(grads, opt_state, (params, table))
        params, table = optax.apply_updates((params, table), updates)
        return params, table, opt_state, loss, grads

    rs = np.random.default_rng(c["seed"])
    losses, smallest = [], np.inf
    for _ in range(steps):
        sel = rs.integers(0, len(data.labels), c["batch"])
        params, table, opt_state, loss, grads = step(
            params, table, opt_state, jnp.asarray(data.keys_idx[sel]),
            jnp.asarray(data.dense[sel]), jnp.asarray(data.labels[sel]))
        losses.append(float(loss))
        for gl in jax.tree_util.tree_leaves(grads):
            a = np.abs(np.asarray(gl))
            if (a > 0).any():
                smallest = min(smallest, float(a[a > 0].min()))
    return np.asarray(losses), smallest, params, table


def test_train_steps_match_jax(monkeypatch):
    """Five train_dlrm steps of the port from the JAX package's initial
    state against the JAX package's own five steps."""
    monkeypatch.setenv("HPS_PALLAS_INTERPRET", "1")
    steps = 5
    data = jap.make_click_dataset(**STEP_DATA)
    losses, smallest, _, _ = _jax_steps(data, steps)
    assert smallest > 1e-7, smallest  # no gradient entry near Adam's eps
    c = STEP_CFG
    _, jparams, jtable = jap.train_dlrm(data, steps=steps, **c)
    _, params0, table0 = _flax_init(c["seed"], STEP_DATA["num_feats"], c["dim"],
                                    c["bottom_widths"], c["top_widths"], STEP_DATA["vocab"])
    model, table, tlosses = tap.train_dlrm(data, steps=steps, **c,
                                           init=(_carry(params0), np.array(table0)),
                                           device="cpu")
    np.testing.assert_allclose(tlosses, losses, rtol=1e-4)
    np.testing.assert_allclose(table, np.asarray(jtable), rtol=1e-4, atol=1e-5)
    want = _carry(jparams)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    # The steps moved the state by many times the tolerance.
    assert np.abs(table - np.asarray(table0)).max() > 100 * 1e-5


def test_train_dlrm_multi_runs_on_one_table():
    """train_dlrm_multi: one stacked table with a row offset per feature;
    the tables come back split, and the loss falls."""
    data = tap.make_multi_click_dataset(4096, [7, 50, 300], seed=2)
    model, tables, losses = tap.train_dlrm_multi(data, dim=8, steps=60, batch=256,
                                                 seed=2, device="cpu")
    assert [t.shape for t in tables] == [(7, 8), (50, 8), (300, 8)]
    assert np.isfinite(losses).all() and losses[-10:].mean() < losses[:10].mean()


def test_dlrm_init_statistics():
    """init_flax_: Flax's lecun_normal (a normal truncated at +-2 std,
    variance 1 / fan_in) and zero biases, from an explicit generator, next
    to the Flax initialisation of the same model."""
    bottom, top, nf = (512, 256, 128), (1024, 512, 1), 26
    model = DLRM(ND, nf, bottom, top).init_flax_(torch.Generator().manual_seed(0))
    again = DLRM(ND, nf, bottom, top).init_flax_(torch.Generator().manual_seed(0))
    flax = _carry(FlaxDLRM(bottom_widths=bottom, top_widths=top).init(
        jax.random.PRNGKey(0), jnp.zeros((2, ND)), jnp.zeros((2, nf, bottom[-1]))))
    for name, w in model.state_dict().items():
        assert torch.equal(w, again.state_dict()[name])
        if name.endswith("bias"):
            assert not w.any()
            continue
        fan_in = w.shape[1]
        trunc_std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
        assert float(w.abs().max()) <= 2 * trunc_std * (1 + 1e-6)
        if w.numel() >= 4096:
            std = (1.0 / fan_in) ** 0.5
            assert abs(float(w.std()) / std - 1) < 0.05, name
            assert abs(float(w.mean())) < 0.05 * std, name
            fw = flax[name]
            assert abs(float(w.std()) / float(fw.std()) - 1) < 0.05, name
            assert abs(float(w.abs().max()) / float(fw.abs().max()) - 1) < 0.05, name


SM_SMEM = 233472  # shared memory of one H100 SM, 1 KB of it reserved per block


@pytest.mark.parametrize("n_feats", [0, 1, 26, 127, 128, 129, 146])
@pytest.mark.parametrize("dim", [1, 4, 36, 64, 128, 130, 1024])
def test_backward_plan_fits(n_feats, dim):
    """The backward kernel's plan fits an H100 for up to 146 fed features
    (F = 147) and D up to 1,024: shared memory of a block, a slice of at most 128
    columns (a multiple of 4 where D is), a 2- or 3-stage ring, a grid of
    no more than the work items."""
    plan = tfi.bwd_plan(777, dim, n_feats, tfi.H100_SMS)
    assert plan.smem == tfi.bwd_smem(n_feats + 1, plan.dc, plan.stages) <= tfi.MAX_SMEM
    assert plan.ctas_per_sm >= 1 and plan.ctas_per_sm * (plan.smem + 1024) <= SM_SMEM
    assert plan.stages in (2, 3) and 1 <= plan.dc <= min(dim, 128)
    assert dim % 4 or plan.dc % 4 == 0
    assert 1 <= plan.grid <= 777 * -(-dim // plan.dc)


def test_backward_plan_at_the_training_shape():
    """B 4096, 26 features, D 128: persistent CTAs, a small multiple of the
    SMs, each walking several samples through a 3-stage ring."""
    plan = tfi.bwd_plan(4096, 128, 26, tfi.H100_SMS)
    assert (plan.stages, plan.dc, plan.ctas_per_sm) == (3, 128, 4)
    assert plan.grid == 4 * tfi.H100_SMS < 4096


def test_backward_plan_refuses_too_many_features():
    """The shared-memory kernel refuses what it cannot hold: past MAX_FEATS
    features and at F = 148 (S, the pair table and two stages pass a
    block's shared memory) the plan is the wide route's; a shape with no
    work to plan still raises."""
    assert isinstance(tfi.bwd_plan(8, 128, tfi.MAX_FEATS + 1), tfi.BwdWidePlan)
    assert isinstance(tfi.bwd_plan(8, 128, 146), tfi.BwdPlan)
    assert tfi.bwd_smem(148, 4, 2) > tfi.MAX_SMEM
    assert isinstance(tfi.bwd_plan(8, 128, 147), tfi.BwdWidePlan)
    for bad in ((8, 128, -1), (8, 0, 26), (-1, 128, 26)):
        with pytest.raises(ValueError):
            tfi.bwd_plan(*bad)
