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
