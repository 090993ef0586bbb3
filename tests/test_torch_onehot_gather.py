"""K6 (the one-hot worklist gather) of the PyTorch port, held bit-identical
to the JAX package's Pallas bodies run in interpret mode.

Tolerance: none. Each output row of either body is one stored row cast to
f32 (times the sum of its scale in v1), so every comparison is for equal
values. The interpreted Pallas bodies accept ``float8_e4m3fn``, so fp8 is
held against them like the other types. The arenas of both packages are
made from the same bytes.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hugectr_backend_tpu.ops import onehot_gather as jog
from hugectr_backend_tpu.tiers.hbm import gather_dequant_xla
from hugectr_backend_tpu_torch.ops import onehot_gather as tog
from hugectr_backend_tpu_torch.scripts.common import tile_layout

R = tog.R_TILE
M = tog.M_TILE
MEMBERS = [[700], [3, 1461, 2174, 5684]]
TORCH_DT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn, "bf16": torch.bfloat16,
            "fp32": torch.float32}
JAX_DT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn, "bf16": jnp.bfloat16,
          "fp32": jnp.float32}
RAW = {1: (torch.uint8, np.uint8), 2: (torch.int16, np.int16), 4: (torch.int32, np.int32)}


def _arena(rng, member_rows, quant="int8", dim=128):
    """-> (torch values, jax values: the same bytes; f32 scales; tiles)."""
    tiles, rows = tile_layout(member_rows, R)
    vals = rng.integers(-127, 128, (rows, dim)).astype(np.float32)
    if quant != "int8":
        vals *= rng.random(vals.shape).astype(np.float32)
    tv = torch.from_numpy(vals).to(TORCH_DT[quant])
    raw_t, raw_np = RAW[tv.element_size()]
    jv = jnp.asarray(tv.view(raw_t).numpy().view(raw_np)).view(JAX_DT[quant])
    scales = (rng.random(rows) * 0.1 + 0.01).astype(np.float32)
    return tv, jv, scales, tiles


def _slots(rng, tiles, member_rows, keys_per_member, outside=0):
    """Per member, slots inside its rows; the first ``outside`` of each
    segment anywhere in [-600, R_pad + 600)."""
    r_pad = sum(nt for _, nt in tiles) * R
    parts = []
    for (t0, _), rows, k in zip(tiles, member_rows, keys_per_member):
        s = t0 * R + rng.integers(0, rows, k)
        s[:outside] = rng.integers(-600, r_pad + 600, outside)
        parts.append(s)
    return np.concatenate(parts).astype(np.int32)


def _v1(tv, jv, scales, slots, tplan, jplan):
    got = tog.onehot_gather(tv, None if scales is None else torch.from_numpy(scales),
                            torch.from_numpy(slots), tplan)
    want = jog.onehot_gather(jv, None if scales is None else jnp.asarray(scales),
                             jnp.asarray(slots), jplan, interpret=True)
    return got.numpy(), np.asarray(want)


def _v2(tv, jv, slots, tplan, jplan):
    got = tog.onehot_gather_rows(tv, torch.from_numpy(slots), tplan)
    want = jog.onehot_gather_rows(jv, jnp.asarray(slots), jplan, interpret=True)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("tiles, keys, m_tile, r_tile", [
    ([(0, 1)], [512], 512, 512),
    ([(0, 2), (2, 1)], [512, 1024], 512, 512),
    ([(0, 12), (12, 3), (15, 1)], [4096, 8192, 4096], 4096, 512),
    ([(3, 2), (0, 1)], [64, 32], 32, 1024),
])
def test_plan_matches_jax(tiles, keys, m_tile, r_tile):
    jp = jog.plan_onehot_worklist(tiles, keys, m_tile=m_tile, r_tile=r_tile)
    tp = tog.plan_onehot_worklist(tiles, keys, m_tile=m_tile, r_tile=r_tile)
    for name in ("kt", "rt", "first"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name))
        assert getattr(tp, name).dtype == np.int32
    assert (tp.num_key_tiles, tp.m_tile, tp.r_tile, tp.steps) == (
        jp.num_key_tiles, jp.m_tile, jp.r_tile, jp.steps)


@pytest.mark.parametrize("tiles, keys", [
    ([(0, 1)], [100]),             # not a whole number of key tiles
    ([(0, 0)], [M]),               # a member without rows
    ([(0, 1), (1, 1)], [M]),       # members and key counts differ in length
])
def test_plan_errors_match_jax(tiles, keys):
    with pytest.raises(ValueError) as jerr:
        jog.plan_onehot_worklist(tiles, keys)
    with pytest.raises(ValueError) as terr:
        tog.plan_onehot_worklist(tiles, keys)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("member_rows", MEMBERS, ids=["700", "four"])
@pytest.mark.parametrize("key_tiles", [1, 3])
@pytest.mark.parametrize("scaled", [True, False], ids=["scales", "no_scales"])
def test_gather_ref_bit_exact_vs_interpreted_jax(member_rows, key_tiles, scaled):
    rng = np.random.default_rng(10 + key_tiles)
    tv, jv, scales, tiles = _arena(rng, member_rows)
    keys = [key_tiles * M] * len(member_rows)
    slots = _slots(rng, tiles, member_rows, keys)
    tplan = tog.plan_onehot_worklist(tiles, keys)
    jplan = jog.plan_onehot_worklist(tiles, keys)
    sc = scales if scaled else None
    got, want = _v1(tv, jv, sc, slots, tplan, jplan)
    np.testing.assert_array_equal(got, want)
    # Every slot inside its member: the same as the gather.
    xla = gather_dequant_xla(jv, None if sc is None else jnp.asarray(sc), jnp.asarray(slots))
    np.testing.assert_array_equal(got, np.asarray(xla))


@pytest.mark.parametrize("member_rows", MEMBERS, ids=["700", "four"])
@pytest.mark.parametrize("quant", ["int8", "fp8", "bf16", "fp32"])
def test_rows_ref_bit_exact_vs_interpreted_jax(member_rows, quant):
    rng = np.random.default_rng(20)
    tv, jv, _, tiles = _arena(rng, member_rows, quant)
    keys = [M] * len(member_rows)
    keys[0] = 2 * M
    slots = _slots(rng, tiles, member_rows, keys)
    got, want = _v2(tv, jv, slots, tog.plan_onehot_worklist(tiles, keys),
                    jog.plan_onehot_worklist(tiles, keys))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(gather_dequant_xla(jv, None,
                                                                     jnp.asarray(slots))))


def test_slot_outside_member_tiles_gives_zero_row_in_both():
    rng = np.random.default_rng(30)
    member_rows = MEMBERS[1]
    tv, jv, scales, tiles = _arena(rng, member_rows)
    keys = [M] * len(member_rows)
    slots = _slots(rng, tiles, member_rows, keys, outside=M // 4)
    tplan = tog.plan_onehot_worklist(tiles, keys)
    jplan = jog.plan_onehot_worklist(tiles, keys)
    own = np.concatenate([np.full(k, i) for i, k in enumerate(keys)])
    lo = np.asarray([t0 * R for t0, _ in tiles])[own]
    hi = np.asarray([(t0 + nt) * R for t0, nt in tiles])[own]
    outside = (slots < lo) | (slots >= hi)
    assert outside.sum() > 100 and (slots < 0).any() and (slots >= hi.max()).any()
    for got, want in (_v1(tv, jv, scales, slots, tplan, jplan),
                      _v2(tv, jv, slots, tplan, jplan)):
        np.testing.assert_array_equal(got, want)
        assert not got[outside].any()
        assert got[~outside].any(axis=1).mean() > 0.9


@pytest.mark.parametrize("rows_only", [False, True])
def test_slots_length_error_matches_jax(rows_only):
    rng = np.random.default_rng(40)
    tv, jv, scales, tiles = _arena(rng, [700])
    plan_t = tog.plan_onehot_worklist(tiles, [M])
    plan_j = jog.plan_onehot_worklist(tiles, [M])
    slots = np.zeros(M - 1, np.int32)
    with pytest.raises(ValueError) as jerr:
        if rows_only:
            jog.onehot_gather_rows(jv, jnp.asarray(slots), plan_j, interpret=True)
        else:
            jog.onehot_gather(jv, jnp.asarray(scales), jnp.asarray(slots), plan_j,
                              interpret=True)
    with pytest.raises(ValueError) as terr:
        if rows_only:
            tog.onehot_gather_rows(tv, torch.from_numpy(slots), plan_t)
        else:
            tog.onehot_gather(tv, torch.from_numpy(scales), torch.from_numpy(slots), plan_t)
    assert str(terr.value) == str(jerr.value)


def test_duplicate_row_tile_visits_add_up_in_both():
    """A run may visit a row tile twice: each visit adds its part (the
    first assigns), so v2 gives 2 x row and v1 (2 x row) x (2 x scale)."""
    rng = np.random.default_rng(50)
    tv, jv, scales, tiles = _arena(rng, [400])
    slots = rng.integers(0, 400, M).astype(np.int32)
    arrays = dict(kt=np.zeros(2, np.int32), rt=np.zeros(2, np.int32),
                  first=np.asarray([1, 0], np.int32), num_key_tiles=1)
    tplan, jplan = tog.OnehotPlan(**arrays), jog.OnehotPlan(**arrays)
    got, want = _v2(tv, jv, slots, tplan, jplan)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, 2 * tv.numpy()[slots].astype(np.float32))
    got, want = _v1(tv, jv, scales, slots, tplan, jplan)
    np.testing.assert_array_equal(got, want)


def _bad_plan(kt=(0, 0, 1, 1), rt=(0, 1, 0, 1), first=(1, 0, 1, 0), nkt=2):
    return tog.OnehotPlan(np.asarray(kt, np.int32), np.asarray(rt, np.int32),
                          np.asarray(first, np.int32), nkt)


@pytest.mark.parametrize("rows, n, plan", [
    (1024, 1024, _bad_plan((0, 1, 0, 1), (0, 0, 1, 1), (1, 1, 0, 0))),  # runs not consecutive
    (1024, 1024, _bad_plan(first=(1, 1, 1, 0))),    # first not at the start of a run
    (1024, 1024, _bad_plan(first=(0, 0, 1, 0))),    # a run without its first
    (1024, 1024, _bad_plan((0, 0), (0, 1), (1, 0))),  # a key tile without a run
    (1024, 1024, _bad_plan(kt=(0, 0, 2, 2))),       # a key tile out of range
    (1024, 1024, _bad_plan(rt=(0, 2, 0, 1))),       # a row tile past the arena
    (1024, 1024, _bad_plan(rt=(-1, 1, 0, 1))),      # a negative row tile
    (1000, 1024, _bad_plan()),                      # arena rows not a multiple of r_tile
    (1024, 1000, _bad_plan()),                      # slots length
], ids=["consecutive", "first", "first0", "missing", "kt_range", "rt_past", "rt_neg",
        "r_pad", "slots"])
def test_invalid_plans_raise(rows, n, plan):
    values = torch.zeros(rows, 16, dtype=torch.int8)
    slots = torch.zeros(n, dtype=torch.int32)
    with pytest.raises(ValueError):
        tog.onehot_gather(values, None, slots, plan)
    with pytest.raises(ValueError):
        tog.onehot_gather_rows(values, slots, plan)


def test_valid_plan_passes_and_uploads_once(monkeypatch):
    plan = _bad_plan()
    calls = []
    real = tog.check_plan
    monkeypatch.setattr(tog, "check_plan", lambda p, r: calls.append(r) or real(p, r))
    values = torch.ones(1024, 16, dtype=torch.int8)
    slots = torch.arange(1024, dtype=torch.int32)
    for _ in range(3):
        out = tog.onehot_gather_rows(values, slots, plan)
    assert calls == [1024]
    offsets, rt, longest = real(plan, 1024)
    assert offsets.tolist() == [0, 2, 4] and rt.tolist() == [0, 1, 0, 1] and longest == 2
    assert torch.equal(out, torch.ones(1024, 16))


def test_int4_arena_and_unknown_devices_raise():
    plan = tog.plan_onehot_worklist([(0, 1)], [M])
    slots = torch.zeros(M, dtype=torch.int32)
    with pytest.raises(TypeError, match="int4"):
        tog.onehot_gather_rows(torch.zeros(R, 8, dtype=torch.uint8), slots, plan)
    # Neither CPU nor CUDA: no plain version to take, and no kernel.
    with pytest.raises(ValueError, match="unsupported device"):
        tog.onehot_gather(torch.zeros(R, 8, dtype=torch.int8, device="meta"), None,
                          slots.to("meta"), plan)


@pytest.mark.parametrize("rows_only", [False, True])
@pytest.mark.parametrize("quant", ["int8", "fp32"])
def test_verify_onehot_path(rows_only, quant):
    rng = np.random.default_rng(60)
    tv, _, scales, tiles = _arena(rng, [700, 40], quant)
    plan = tog.plan_onehot_worklist(tiles, [M, M])
    sc = torch.from_numpy(scales) if quant == "int8" else None
    assert tog.verify_onehot_path(tv, sc, plan, tiles, rows_only=rows_only) is True


def test_nonfinite_arena_follows_the_gather():
    """The port's choice, pinned: the TPU body multiplies the 0/1 mask by the
    whole row tile, so one inf in a tile gives 0 * inf = NaN in its column
    for every key of the tile (the interpreted Pallas body shows it); the
    port follows the gather, the contract the JAX docstrings state."""
    vals = np.zeros((R, 8), np.float32)
    vals[:, :] = np.arange(R, dtype=np.float32)[:, None]
    vals[300, 5] = np.inf
    slots = (np.arange(M) % 200).astype(np.int32)
    tplan = tog.plan_onehot_worklist([(0, 1)], [M])
    jplan = jog.plan_onehot_worklist([(0, 1)], [M])
    got, jax_rows = _v2(torch.from_numpy(vals), jnp.asarray(vals), slots, tplan, jplan)
    assert np.isnan(jax_rows[:, 5]).all()
    np.testing.assert_array_equal(jax_rows[:, :5], vals[slots, :5])
    np.testing.assert_array_equal(
        got, np.asarray(gather_dequant_xla(jnp.asarray(vals), None, jnp.asarray(slots))))
    assert np.isfinite(got).all()
    hit = tog.onehot_gather_rows(torch.from_numpy(vals), torch.full((M,), 300, dtype=torch.int32),
                                 tplan)
    assert torch.isinf(hit[:, 5]).all()


# ------------------------------------------------------------ sign of zero
#
# The interpreted Pallas bodies sum a one-hot product from +0, so they give
# +0.0 for a -0.0 value. The port's walk (the first step assigns the row,
# each later step adds the row or 0) keeps -0.0 where every step of the
# key's run hits and gives +0.0 where one missed (-0.0 + 0.0). Every other
# bit pattern is the same on both sides.


def _bits(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).view(torch.int32)


def _neg_zero_arena(rng, member_rows, quant):
    """As ``_arena``, with about a quarter of the values -0.0."""
    tiles, rows = tile_layout(member_rows, R)
    vals = rng.integers(-127, 128, (rows, 16)).astype(np.float32)
    vals *= rng.random(vals.shape).astype(np.float32)
    vals[rng.random(vals.shape) < 0.25] = -0.0
    tv = torch.from_numpy(vals).to(TORCH_DT[quant])
    raw_t, raw_np = RAW[tv.element_size()]
    jv = jnp.asarray(tv.view(raw_t).numpy().view(raw_np)).view(JAX_DT[quant])
    scales = (rng.random(rows) * 0.1 + 0.01).astype(np.float32)
    return tv, jv, scales, tiles


def _check_zero_signs(got, want, keep_neg):
    """``got`` (the port) and ``want`` (the interpreted body) equal bit for
    bit off the zeros; the body's zeros all +0.0; the port's -0.0 exactly
    at ``keep_neg``."""
    gb, wb = _bits(got), _bits(want)
    nonzero = torch.from_numpy(want != 0)
    assert torch.equal(gb[nonzero], wb[nonzero])
    zero = ~nonzero
    assert torch.equal(torch.from_numpy(got == 0), zero)
    assert not np.signbit(want[zero.numpy()]).any()
    assert np.array_equal(np.signbit(got) & zero.numpy(), keep_neg & zero.numpy())


@pytest.mark.parametrize("quant", ["fp8", "bf16", "fp32"])
def test_negative_zero_follows_the_walk(quant):
    """Member 0 spans one row tile (every step of its keys' runs hits: -0.0
    kept, as the gather keeps it); member 1 spans two (each key misses one:
    +0.0)."""
    rng = np.random.default_rng(70)
    member_rows = [3, 700]
    tv, jv, scales, tiles = _neg_zero_arena(rng, member_rows, quant)
    keys = [M, M]
    slots = _slots(rng, tiles, member_rows, keys)
    tplan = tog.plan_onehot_worklist(tiles, keys)
    jplan = jog.plan_onehot_worklist(tiles, keys)
    gathered = tv.float().numpy()[slots]
    keep_neg = np.signbit(gathered) & (gathered == 0) & (np.arange(2 * M) < M)[:, None]
    assert keep_neg.sum() > 100 and (np.signbit(gathered) & (gathered == 0))[M:].sum() > 100
    got, want = _v2(tv, jv, slots, tplan, jplan)
    _check_zero_signs(got, want, keep_neg)
    # Where every step hits, the walk is the gather, -0.0 included.
    assert torch.equal(_bits(got[:M]), _bits(gathered[:M]))
    got, want = _v1(tv, jv, scales, slots, tplan, jplan)
    _check_zero_signs(got, want, keep_neg)


@pytest.mark.parametrize("quant", ["fp8", "bf16", "fp32"])
@pytest.mark.parametrize("rt", [(0, 0), (0, 1, 0)], ids=["twice", "twice_with_a_miss"])
def test_duplicate_visits_keep_their_bits(quant, rt):
    """A run that visits row tile 0 twice: 2 x row bit for bit, and -0.0
    kept only where no step of the run misses."""
    rng = np.random.default_rng(80 + len(rt))
    tv, jv, scales, _ = _neg_zero_arena(rng, [700], quant)
    slots = rng.integers(0, R, M).astype(np.int32)
    arrays = dict(kt=np.zeros(len(rt), np.int32), rt=np.asarray(rt, np.int32),
                  first=np.asarray([1] + [0] * (len(rt) - 1), np.int32), num_key_tiles=1)
    tplan, jplan = tog.OnehotPlan(**arrays), jog.OnehotPlan(**arrays)
    gathered = tv.float().numpy()[slots]
    keep_neg = np.signbit(gathered) & (gathered == 0) & (len(rt) == 2)
    got, want = _v2(tv, jv, slots, tplan, jplan)
    _check_zero_signs(got, want, keep_neg)
    off = gathered != 0
    assert torch.equal(_bits(got[off]), _bits(2 * gathered[off]))
    got, want = _v1(tv, jv, scales, slots, tplan, jplan)
    _check_zero_signs(got, want, keep_neg)
