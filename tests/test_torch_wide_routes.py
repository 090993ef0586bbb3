"""The routes past the card's former shape limits, on the CPU: the launch
plans (plain Python) and the plain versions the card's kernels are held
against.

- At the main path's shapes every plan is the one it was before the wide
  routes existed (values pinned below): K3/K2/K4's forward at B 4096, F
  27, D 128; the backward at the training shape; K5 at the 8 layer shapes
  of the w8a8 DLRM, with and without 16-byte weight rows.
- Past each former limit the plan names the new route instead of raising:
  the forward past one warp's shared memory (F 689 at D 128) or past 1,024
  descriptors; the backward past F 147 or past 1,024 features; K5 with N
  <= 8 past the GEMV's K of 29,056.
- The plain forward (K4 and K2) at F past 147 against the interpreted
  Pallas bodies, and the plain backward against the JAX package's custom
  VJP, at the interaction tests' tolerances: forward rtol 1e-5, atol 1e-6 *
  max|z|^2 (bf16 z, f32 sums in another order); backward rtol 1e-5, atol
  1e-6 * F * max|g| * max|z|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hugectr_backend_tpu.ops import fused_interaction as jfi
from hugectr_backend_tpu_torch.ops import fused_interaction as tfi
from hugectr_backend_tpu_torch.ops import quant_matmul as qm

SMS = tfi.H100_SMS

# The plans at the main path's shapes, as they were before the wide routes.
K3_CRITEO = tfi.K3Plan(warps=8, smem=83328, grid=264, ctas_per_sm=2)
BWD_TRAIN = tfi.BwdPlan(stages=3, dc=128, grid=528, threads=128, smem=52096, ctas_per_sm=4)
# (M, N, K, 16-byte weight rows) -> (variant, bm, bn, stages, grid, qgrid, smem)
K5_LAYERS = {
    (4096, 512, 13, True): ("tile", 64, 128, 4, (64, 4), 0, 62720),
    (4096, 512, 13, False): ("tile", 64, 128, 4, (64, 4), 0, 62720),
    (4096, 256, 512, True): ("wgmma", 64, 128, 4, (64, 2), 512, 116736),
    (4096, 256, 512, False): ("narrow", 16, 64, 0, (528, 1), 0, 47168),
    (4096, 128, 256, True): ("narrow", 16, 64, 0, (512, 1), 0, 26688),
    (4096, 128, 256, False): ("narrow", 16, 64, 0, (512, 1), 0, 26688),
    (4096, 1024, 479, True): ("wgmma", 128, 128, 3, (32, 8), 512, 100864),
    (4096, 1024, 479, False): ("narrow", 16, 128, 0, (528, 1), 0, 85568),
    (4096, 1024, 1024, True): ("wgmma", 128, 128, 3, (32, 8), 512, 100864),
    (4096, 1024, 1024, False): ("tile", 64, 128, 8, (64, 8), 512, 124160),
    (4096, 512, 1024, True): ("wgmma", 64, 128, 3, (64, 4), 512, 76032),
    (4096, 512, 1024, False): ("tile", 64, 128, 8, (64, 4), 512, 124160),
    (4096, 1, 256, True): ("gemv", 8, 1, 0, (512, 1), 0, 256),
    (4096, 1, 256, False): ("gemv", 8, 1, 0, (512, 1), 0, 256),
}


@pytest.mark.parametrize("descs", [None, 12, 14, 26])
def test_forward_plan_at_the_criteo_shape_is_unchanged(descs):
    assert tfi.k3_plan(4096, 27, 128, SMS, descs) == K3_CRITEO


def test_backward_plan_at_the_training_shape_is_unchanged():
    assert tfi.bwd_plan(4096, 128, 26, SMS) == BWD_TRAIN


@pytest.mark.parametrize("shape", sorted(K5_LAYERS), ids=str)
def test_k5_plans_at_the_dlrm_layers_are_unchanged(shape):
    m, n, k, wvec = shape
    p = qm.k5_plan(m, n, k, SMS, wvec)
    assert (p.variant, p.bm, p.bn, p.stages, p.grid, p.qgrid, p.smem) == K5_LAYERS[shape]
    assert p.threads == 256


@pytest.mark.parametrize("batch, feats, dim, descs", [
    (4096, 689, 128, None),   # one warp's z tile and stage pass 232,448 bytes
    (4096, 1100, 128, None),
    (8, 1100, 4, None),       # fits shared memory, but 1,099 fed descriptors
    (8, 30, 128, 1025),       # 1,025 one-hot members
    (1, 5000, 16, None),
    (4096, 800, 128, None),   # z past a block's shared memory: in device memory
])
def test_forward_plan_past_the_old_limits_is_the_wide_route(batch, feats, dim, descs):
    p = tfi.k3_plan(batch, feats, dim, SMS, descs)
    assert isinstance(p, tfi.K3WidePlan)
    assert p.threads == 256 and 1 <= p.grid <= min(batch, 2 * SMS)
    assert p.f_pad == -(-feats // 16) * 16 and p.d_pad == -(-dim // 16) * 16
    # z in shared memory where its tile and the stages fit a block's, and as
    # many CTAs an SM as fit the SM's; else in device memory.
    tile = 2 * p.f_pad * (p.d_pad + 8)
    if p.smem:
        assert p.smem == tile and tile + 8 * 16 * 33 * 4 <= tfi.MAX_SMEM
        assert p.grid <= max(1, tfi.SM_SMEM // (tile + 8 * 16 * 33 * 4 + 1024)) * SMS
    else:
        assert tile + 8 * 16 * 33 * 4 > tfi.MAX_SMEM


def test_forward_plan_just_inside_the_limits_is_unchanged():
    assert isinstance(tfi.k3_plan(4096, 688, 128), tfi.K3Plan)
    assert isinstance(tfi.k3_plan(8, 1025, 4, SMS, 1024), tfi.K3Plan)


@pytest.mark.parametrize("batch, dim, n_feats", [
    (4096, 128, 147), (4096, 128, 699), (64, 4, 1024), (8, 128, 1100), (1, 1, 3000)])
def test_backward_plan_past_the_old_limits_is_the_wide_route(batch, dim, n_feats):
    p = tfi.bwd_plan(batch, dim, n_feats, SMS)
    assert isinstance(p, tfi.BwdWidePlan)
    items = batch * -(-(n_feats + 1) // p.rows) * dim
    assert p.threads == 128 and p.rows == 8
    assert 1 <= p.grid <= 16 * SMS and p.grid <= -(-items // 128)


@pytest.mark.parametrize("k", [29057, 30000, 100000, qm.MAX_K])
@pytest.mark.parametrize("n", [1, 8])
def test_k5_past_the_gemv_takes_the_product(k, n):
    """N <= 8 past K 29,056: the mma.sync product after the quantize kernel
    on 32 x 64 tiles, within shared memory."""
    for m in (4096, 1):
        p = qm.k5_plan(m, n, k, SMS)
        assert p.variant == "tile" and p.stages == 8 and p.qgrid == -(-m // 8)
        assert (p.bm, p.bn) == (32, 64)
        assert p.grid == (-(-m // p.bm), 1) and p.smem <= qm.MAX_SMEM
    assert qm.k5_plan(4096, n, qm.GEMV_MAX_K, SMS).variant == "gemv"
    with pytest.raises(ValueError):
        qm.k5_plan(4096, n, qm.MAX_K + 1, SMS)


def test_k5_max_k_is_the_int32_sums_exact_range():
    assert 127 * 127 * qm.MAX_K < 2 ** 31 <= 127 * 127 * (qm.MAX_K + 1)


def _zmax(*arrays) -> float:
    return max(float(np.abs(np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                                       .astype(jnp.float32))).max()) for a in arrays)


@pytest.mark.parametrize("t", [148, 699])
def test_plain_forward_past_147_features_matches_pallas(t):
    """F = 149 and 700 at D 8, B 8: K4's and K2's plain versions against the
    interpreted Pallas bodies."""
    b, d = 8, 8
    rng = np.random.default_rng(300 + t)
    bottom = rng.standard_normal((b, d)).astype(np.float32)
    emb = rng.standard_normal((b, t, d)).astype(np.float32)
    zm = _zmax(bottom, emb)
    want = np.asarray(jfi.fused_dot_interaction(jnp.asarray(bottom), jnp.asarray(emb), True))
    got = tfi.fused_dot_interaction(torch.from_numpy(bottom), torch.from_numpy(emb))
    assert got.shape == want.shape == (b, d + (t + 1) * t // 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * zm * zm)
    if t > 200:
        return
    parts = [np.ascontiguousarray(np.moveaxis(emb[:, : t // 2], 1, 0)),
             np.ascontiguousarray(np.moveaxis(emb[:, t // 2:], 1, 0))]
    fmap = tuple([(0, i) for i in range(t // 2)] + [(1, i) for i in range(t - t // 2)])
    want_p = np.asarray(jfi.fused_dot_interaction_parts(
        jnp.asarray(bottom), [jnp.asarray(p) for p in parts], fmap, True))
    got_p = tfi.dot_interaction_parts(torch.from_numpy(bottom),
                                      [torch.from_numpy(p) for p in parts], fmap)
    np.testing.assert_allclose(got_p.detach().numpy(), want_p, rtol=1e-5, atol=1e-6 * zm * zm)


@pytest.mark.parametrize("t", [147, 699])
def test_plain_backward_past_147_features_matches_jax(t):
    """F = 148 and 700 at D 8, B 8: d/d(bottom, emb) of sum(out^2) through
    the port's K4 (its backward's plain version on the CPU) against jax.grad
    of the interpreted Pallas K4 (its custom VJP)."""
    b, d = 8, 8
    rng = np.random.default_rng(400 + t)
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
    atol = 1e-6 * (t + 1) * float(np.abs(g).max()) * max(float(np.abs(bottom).max()),
                                                          float(np.abs(emb).max()))
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jg_b), rtol=1e-5, atol=atol)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jg_e), rtol=1e-5, atol=atol)
