"""K2 / K3 (the fused DLRM dot interaction) of the PyTorch port against the
Pallas bodies of the JAX package, run in interpret mode.

Tolerance: rtol 1e-5 with atol 1e-6 * max|z|^2. Both sides round z to bf16
and sum exact bf16 x bf16 products in f32; only the order of the f32 sums
differs, and the atol covers pairs whose sum cancels to near zero.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hugectr_backend_tpu.ops import fused_interaction as jfi
from hugectr_backend_tpu_torch.ops import fused_interaction as tfi

D = 128
PART_SHAPES = ((5, 3), (3, 0), (1, 8))  # (rows, phantom tail rows beyond B)


def _parts(b, seed):
    rng = np.random.default_rng(seed)
    bottom = rng.standard_normal((b, D)).astype(np.float32)
    parts = [rng.standard_normal((n, b + extra, D)).astype(np.float32)
             for n, extra in PART_SHAPES]
    return bottom, parts


def _assert_close(got, want, feats):
    zmax = max(float(np.abs(np.asarray(jnp.asarray(f).astype(jnp.bfloat16)
                                       .astype(jnp.float32))).max()) for f in feats)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * zmax * zmax)


GENERAL = ((1, 2), (0, 0), (2, 0), (0, 3), (1, 0), (0, 1))  # not part-major
PART_MAJOR = ((0, 0), (0, 1), (0, 2), (1, 0), (2, 0))  # unmapped rows of part 0/1


@pytest.mark.parametrize("b", [8, 16])
@pytest.mark.parametrize("fmap", [GENERAL, PART_MAJOR], ids=["general", "part_major"])
def test_parts_plain_vs_pallas(b, fmap):
    bottom, parts = _parts(b, seed=b)
    want = np.asarray(jfi.fused_dot_interaction_parts(
        jnp.asarray(bottom), [jnp.asarray(p) for p in parts], fmap, True))
    got = tfi.dot_interaction_parts(torch.from_numpy(bottom),
                                    [torch.from_numpy(p) for p in parts], fmap)
    f = len(fmap) + 1
    assert got.shape == want.shape == (b, D + f * (f - 1) // 2)
    np.testing.assert_array_equal(got[:, :D].numpy(), bottom)
    _assert_close(got.numpy(), want, [bottom] + [parts[p][s][:b] for p, s in fmap])


_ARENAS = {
    "int8": (jnp.int8, torch.int8),
    "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
    "bf16": (jnp.bfloat16, torch.bfloat16),
}


@pytest.mark.parametrize("b", [8, 16])
@pytest.mark.parametrize("dtype", sorted(_ARENAS))
def test_oh_parts_plain_vs_pallas(b, dtype):
    jdt, tdt = _ARENAS[dtype]
    rng = np.random.default_rng(100 + b)
    bottom, parts = _parts(b, seed=200 + b)
    members = ((0, 128), (128, 256), (384, 128))  # 128-aligned member blocks
    raw = np.clip(np.rint(rng.standard_normal((512, D)) * 40), -127, 127).astype(np.float32)
    arena_j = jnp.asarray(raw).astype(jdt)
    arena_t = torch.from_numpy(raw).to(tdt)
    stride = b + 8  # the lookup engine's padded per-member stride
    slots = np.stack([rng.integers(off, off + size, stride) for off, size in members])
    slots = slots.astype(np.int32)
    scales = (rng.random((3, stride)) * 0.05 + 0.001).astype(np.float32)
    used = (3, 1, 1)  # rows fetched per part: phantom rows excluded
    fmap = tuple((p, s) for p, n in enumerate(used) for s in range(n))
    want = np.asarray(jfi.fused_dot_interaction_oh_parts(
        jnp.asarray(bottom), arena_j, jnp.asarray(slots[:, :b]), jnp.asarray(scales[:, :b]),
        tuple(jnp.asarray(p) for p in parts), members=members, interpret=True,
        part_rows=used))
    got = tfi.dot_interaction_oh_parts(
        torch.from_numpy(bottom), arena_t, torch.from_numpy(slots),
        torch.from_numpy(scales), [torch.from_numpy(p) for p in parts], fmap)
    oh = [np.asarray(arena_j[slots[j, :b]].astype(jnp.float32)) * scales[j, :b, None]
          for j in range(3)]
    assert got.shape == want.shape
    _assert_close(got.numpy(), want, [bottom] + oh + [parts[p][s][:b] for p, s in fmap])


def test_feature_order_helpers_match():
    fmap = ((2, 0), (0, 1), (1, 0), (0, 0), (1, 1))
    assert tfi.is_part_major(fmap) == jfi.is_part_major(fmap)
    order, new_map = tfi.part_major_order(fmap)
    jorder, jmap = jfi.part_major_order(fmap)
    assert list(order) == list(jorder) and tuple(new_map) == tuple(jmap)
    assert tfi.is_part_major(new_map) and jfi.is_part_major(new_map)
    np.testing.assert_array_equal(tfi.interaction_permutation(order, 16),
                                  jfi.interaction_permutation(order, 16))
    kernel = np.random.default_rng(0).standard_normal((16 + 15, 4))
    np.testing.assert_array_equal(tfi.permute_top_mlp_kernel(kernel, order, 16),
                                  jfi.permute_top_mlp_kernel(kernel, order, 16))


# ------------------------------------- member bounds, wide F, the launch plan

from hypothesis import given, settings, strategies as st  # noqa: E402

MEMBERS = ((0, 128), (128, 256), (384, 128))


def _oh_case(b, dtype, seed):
    """K3's inputs with slots outside their member (inside the arena)."""
    jdt, tdt = _ARENAS[dtype]
    rng = np.random.default_rng(seed)
    bottom, parts = _parts(b, seed=seed + 1)
    raw = np.clip(np.rint(rng.standard_normal((512, D)) * 40), -127, 127).astype(np.float32)
    stride = b + 8
    slots = np.stack([rng.integers(off, off + size, stride) for off, size in MEMBERS])
    slots[:, ::3] = rng.integers(0, 512, (3, len(slots[0, ::3])))  # outside the member, mostly
    slots = slots.astype(np.int32)
    scales = (rng.random((3, stride)) * 0.05 + 0.001).astype(np.float32)
    return jdt, tdt, bottom, parts, raw, slots, scales


@pytest.mark.parametrize("dtype", sorted(_ARENAS))
def test_oh_parts_out_of_member_slots_give_zero_rows(dtype):
    """A slot outside its member gives a zero row in the Pallas body (its
    one-hot mask over the member is all zero); the port's plain version
    follows it when given the members, and differs without them."""
    b = 16
    jdt, tdt, bottom, parts, raw, slots, scales = _oh_case(b, dtype, seed=7)
    used = (3, 1, 1)
    fmap = tuple((p, s) for p, n in enumerate(used) for s in range(n))
    want = np.asarray(jfi.fused_dot_interaction_oh_parts(
        jnp.asarray(bottom), jnp.asarray(raw).astype(jdt), jnp.asarray(slots[:, :b]),
        jnp.asarray(scales[:, :b]), tuple(jnp.asarray(p) for p in parts), members=MEMBERS,
        interpret=True, part_rows=used))
    args = (torch.from_numpy(bottom), torch.from_numpy(raw).to(tdt), torch.from_numpy(slots),
            torch.from_numpy(scales), [torch.from_numpy(p) for p in parts], fmap)
    got = tfi.dot_interaction_oh_parts(*args, MEMBERS)
    rows = tfi.oh_rows_ref(args[1], args[2], args[3], b, MEMBERS)
    for j, (off, size) in enumerate(MEMBERS):
        outside = (slots[j, :b] < off) | (slots[j, :b] >= off + size)
        assert outside.any() and not rows[j][torch.from_numpy(outside)].any()
    _assert_close(got.numpy(), want,
                  [bottom] + [r.numpy() for r in rows] + [parts[p][s][:b] for p, s in fmap])
    unbounded = tfi.dot_interaction_oh_parts(*args)  # every member the whole arena
    assert not np.allclose(unbounded.numpy(), want, rtol=1e-5, atol=1e-3)


def test_oh_rows_outside_the_arena_are_nan():
    """The kernel's choice for a slot outside the arena (the host refuses
    such slots before upload): a NaN row, in the plain version too."""
    arena = torch.ones((10, 4), dtype=torch.int8)
    slots = torch.tensor([[0, 9, 10, -1]], dtype=torch.int32)
    (row,) = tfi.oh_rows_ref(arena, slots, None, 4, ((0, 5),))
    assert row[0].eq(1).all() and row[1].eq(0).all() and row[2:].isnan().all()


def test_nonfinite_arena_follows_the_gather():
    """The port's choice, pinned, as K6's: the Pallas body multiplies the
    0/1 mask by the whole member, so one inf in a member gives 0 * inf = NaN
    in its column for every key of the member (the interpreted body shows
    it); the port builds each row by a gather, so only the key that hits the
    inf row sees it."""
    b = 8
    raw = np.ones((128, D), np.float32)
    raw[5, 3] = np.inf
    slots = np.full((1, b), 7, np.int32)
    slots[0, 2] = 5
    bottom = np.random.default_rng(0).standard_normal((b, D)).astype(np.float32)
    scales = np.ones((1, b), np.float32)
    want = np.asarray(jfi.fused_dot_interaction_oh_parts(
        jnp.asarray(bottom), jnp.asarray(raw).astype(jnp.bfloat16), jnp.asarray(slots),
        jnp.asarray(scales), (), members=((0, 128),), interpret=True, part_rows=()))
    got = tfi.dot_interaction_oh_parts(
        torch.from_numpy(bottom), torch.from_numpy(raw).to(torch.bfloat16),
        torch.from_numpy(slots), torch.from_numpy(scales), [], (), ((0, 128),)).numpy()
    # The one pair (bottom, one-hot row): non-finite for every key, NaN where
    # the key missed the inf row.
    assert not np.isfinite(want[:, D]).any() and np.isnan(np.delete(want[:, D], 2)).all()
    assert np.isfinite(np.delete(got, 2, axis=0)).all() and not np.isfinite(got[2, D])
    np.testing.assert_array_equal(got[:, :D], bottom)


@pytest.mark.parametrize("t", [128, 299])
def test_plain_vs_pallas_past_128_features(t):
    """F = 129 and 300 (the card's former limit was 128 fed features): K4's
    and K2's plain versions against the interpreted Pallas bodies."""
    b = 8
    rng = np.random.default_rng(t)
    bottom = rng.standard_normal((b, D)).astype(np.float32)
    emb = rng.standard_normal((b, t, D)).astype(np.float32)
    want = np.asarray(jfi.fused_dot_interaction(jnp.asarray(bottom), jnp.asarray(emb),
                                                interpret=True))
    got = tfi.fused_dot_interaction(torch.from_numpy(bottom), torch.from_numpy(emb))
    feats = [bottom] + list(np.moveaxis(emb, 1, 0))
    _assert_close(got.detach().numpy(), want, feats)
    parts = [np.ascontiguousarray(np.moveaxis(emb[:, : t // 2], 1, 0)),
             np.ascontiguousarray(np.moveaxis(emb[:, t // 2:], 1, 0))]
    fmap = tuple([(0, i) for i in range(t // 2)] + [(1, i) for i in range(t - t // 2)])
    want_p = np.asarray(jfi.fused_dot_interaction_parts(
        jnp.asarray(bottom), [jnp.asarray(p) for p in parts], fmap, True))
    got_p = tfi.dot_interaction_parts(torch.from_numpy(bottom),
                                      [torch.from_numpy(p) for p in parts], fmap)
    _assert_close(got_p.detach().numpy(), want_p, feats)


def test_k3_plan_at_the_criteo_shape():
    """B 4096, F 27, D 128: 8 warps per CTA, 2 CTAs per SM (16 warps, 128
    registers a thread), a persistent grid that fits the card at once."""
    plan = tfi.k3_plan(4096, 27, 128)
    assert (plan.warps, plan.ctas_per_sm, plan.grid) == (8, 2, 2 * tfi.H100_SMS)
    assert plan.smem == 8 * tfi.k3_warp_bytes(27, 128) and 2 * (plan.smem + 1024) <= tfi.SM_SMEM


@settings(max_examples=300, deadline=None)
@given(batch=st.integers(0, 70_000), feats=st.integers(1, 688), dim=st.integers(1, 128),
       sms=st.sampled_from([tfi.H100_SMS, 1, 7]))
def test_k3_plan_fits_and_covers_every_sample_once(batch, feats, dim, sms):
    plan = tfi.k3_plan(batch, feats, dim, sms)
    assert 1 <= plan.warps <= 8 and plan.smem == plan.warps * tfi.k3_warp_bytes(feats, dim)
    assert plan.smem <= tfi.MAX_SMEM and plan.ctas_per_sm * (plan.smem + 1024) <= tfi.SM_SMEM
    assert plan.ctas_per_sm * plan.warps <= 16  # 128 registers a thread
    assert plan.grid <= plan.ctas_per_sm * sms  # every CTA resident: a persistent grid
    if batch:
        step = plan.grid * plan.warps  # warp w takes samples w, w + step, ...
        walked = sorted(b for w in range(step) for b in range(w, batch, step))
        assert walked == list(range(batch))
    # The stage holds the largest row block: the bottom and rows 0..15's pairs.
    r1 = min(feats - 1, 16)
    assert tfi.k3_stage_len(feats, dim) >= 3 + dim + r1 * (2 * feats - r1 - 1) // 2


def test_k3_plan_names_the_shared_memory_limit():
    """F = 688 at D = 128 is the last shape whose z tile and stage fit one
    warp's shared memory; one feature more takes the wide route."""
    assert tfi.k3_plan(4096, 688, 128).warps == 1
    assert tfi.k3_warp_bytes(688, 128) <= tfi.MAX_SMEM < tfi.k3_warp_bytes(689, 128)
    assert isinstance(tfi.k3_plan(4096, 689, 128), tfi.K3WidePlan)


def test_card_launchers_refuse_cpu_operands():
    """The forward launcher, which the wrappers reach only for CUDA tensors,
    checks its operands before it builds anything: CPU ones are refused by
    name."""
    bottom = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        tfi._launch("dot_interaction_parts", bottom, [torch.zeros(1, 2, 4)], ((0, 0),))
    oh = (torch.zeros(3, 4, dtype=torch.int8), torch.zeros(1, 2, dtype=torch.int32), None, None)
    with pytest.raises(ValueError, match="unsupported device"):
        tfi._launch("dot_interaction_oh_parts", bottom, [], (), oh=oh)
    with pytest.raises(ValueError, match="unsupported device"):
        tfi.dot_interaction_bwd(bottom.to("meta"), [torch.zeros(1, 2, 4, device="meta")],
                                ((0, 0),), torch.zeros(2, 5, device="meta"))
