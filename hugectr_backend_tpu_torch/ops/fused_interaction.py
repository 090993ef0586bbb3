"""K2 / K3: the fused DLRM dot interaction (``csrc/dot_interaction.cu``).

``concat([bottom, triu(z z^T, 1)])`` with ``z = [bottom; features]``, z
rounded to bf16 and the products summed in f32 — what the JAX package's
Pallas bodies compute (its ops/fused_interaction.py:298, :322, :620):

- K2 :func:`dot_interaction_parts`: the features are rows of the lookup
  engine's chunked outputs (``parts[i]`` [n_i, S_i, D], S_i >= B), placed by
  ``feature_map[t] = (part, sub)``. Unmapped (phantom) rows are never read.
- K3 :func:`dot_interaction_oh_parts`: K2 whose first ``n_oh`` features are
  built in the kernel from a small quantized one-hot arena:
  ``bf16(f32(arena[slots[j, b]]) * scales[j, b])``.

The wrappers launch the kernel for CUDA tensors and raise if they cannot;
they take the plain versions (``*_ref``) only for CPU tensors. The host-side
helpers for feature orders (``is_part_major``, ``part_major_order``,
``interaction_permutation``, ``permute_top_mlp_kernel``) are copies of the
JAX package's.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional

import numpy as np
import torch

from hugectr_backend_tpu_torch.ops import kernels

MAX_FEATS = 128  # HPS_MAX_FEATS in csrc/dot_interaction.cu

# Arena dtype -> the `arena_kind` code of csrc/dot_interaction.cu.
_ARENA_KIND = {
    torch.int8: 0,
    torch.float8_e4m3fn: 1,
    torch.bfloat16: 2,
    torch.float32: 3,
}

_bound = False


class EmbParts:
    """Embedding features held as the lookup engine's chunked outputs.

    ``parts[i]`` is [n_i, S_i, D] (S_i >= B: groups are padded to pow2
    buckets); ``feature_map[t] = (part_idx, sub_idx)`` places each feature;
    ``batch`` is the logical batch. ``oh`` optionally carries a one-hot
    lookup group that was not looked up, as ``(values, slots, scales,
    members)``: ``values`` [R, D] arena, ``slots``/``scales`` [n_oh, >=B]
    (``scales`` may be None: unquantized), ``members`` ((offset, size), ...).
    Those features come FIRST, before every ``feature_map`` entry, and K3
    builds them in the kernel."""

    def __init__(self, parts, feature_map, batch: Optional[int] = None, oh=None):
        self.parts = list(parts)
        self.feature_map = tuple(tuple(x) for x in feature_map)
        self.oh = oh
        if batch is not None:
            self.batch = int(batch)
        elif self.parts:
            self.batch = int(self.parts[0].shape[1])
        else:
            self.batch = int(oh[1].shape[1])

    @property
    def shape(self):
        dim = self.parts[0].shape[2] if self.parts else self.oh[0].shape[-1]
        n_oh = 0 if self.oh is None else len(self.oh[3])
        return (self.batch, n_oh + len(self.feature_map), dim)


def is_part_major(feature_map) -> bool:
    """True when features enumerate parts in order with contiguous subs
    ((0,0),(0,1),...,(1,0),... )."""
    want_p, want_s = 0, 0
    for p, s in feature_map:
        if p == want_p and s == want_s:
            want_s += 1
            continue
        if p == want_p + 1 and s == 0:
            want_p, want_s = p, 1
            continue
        return False
    return True


def part_major_order(feature_map):
    """-> (order, new_feature_map): ``order[i]`` is the ORIGINAL feature
    index placed at position i when features are sorted part-major."""
    order = sorted(range(len(feature_map)), key=lambda t: feature_map[t])
    new_map = tuple(feature_map[t] for t in order)
    return order, new_map


def interaction_permutation(order, dim: int):
    """Row permutation for the FIRST top-MLP kernel when the interaction's
    features are reordered by ``order`` (new position i <- original
    order[i]). Returns ``src`` with new_kernel[j] = old_kernel[src[j]] for j
    in [0, dim + P)."""
    feats = len(order) + 1  # +1 for bottom at z index 0
    rows, cols = np.triu_indices(feats, k=1)
    old_pair_idx = {(int(r), int(c)): k for k, (r, c) in
                    enumerate(zip(rows, cols))}
    zmap = [0] + [1 + t for t in order]
    src = list(range(dim))
    for r, c in zip(rows, cols):
        a, b = zmap[int(r)], zmap[int(c)]
        if a > b:
            a, b = b, a
        src.append(dim + old_pair_idx[(a, b)])
    return np.asarray(src, dtype=np.int64)


def permute_top_mlp_kernel(kernel: np.ndarray, order, dim: int):
    """new_kernel = old_kernel[interaction_permutation(order, dim)] for a
    [dim + P, width] kernel (for a torch weight [width, dim + P], permute
    its columns)."""
    return np.asarray(kernel)[interaction_permutation(order, dim)]


# ------------------------------------------------------------ plain versions


@contextlib.contextmanager
def _full_f32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _interaction_ref(bottom: torch.Tensor, feats) -> torch.Tensor:
    z = torch.stack([bottom] + list(feats), dim=1)  # [B, F, D]
    z = z.to(torch.bfloat16).float()
    with _full_f32_matmul():
        zzt = torch.bmm(z, z.transpose(1, 2))
    f = z.shape[1]
    r, c = torch.triu_indices(f, f, 1, device=z.device)
    return torch.cat([bottom, zzt[:, r, c]], dim=1)


def _mapped(parts, feature_map, batch):
    return [parts[p][s][:batch] for p, s in feature_map]


def oh_rows_ref(arena, slots, scales, batch):
    """The first ``batch`` one-hot features K3 builds, the plain way: a list
    of [batch, D] f32 rows ``f32(arena[slots[j]]) * scales[j]``."""
    rows = []
    for j in range(slots.shape[0]):
        idx = slots[j, :batch].long()
        if arena.dtype == torch.float8_e4m3fn:
            r = arena.view(torch.uint8).index_select(0, idx).view(arena.dtype).float()
        else:
            r = arena.index_select(0, idx).float()
        if scales is not None:
            r = r * scales[j, :batch][:, None]
        rows.append(r)
    return rows


def dot_interaction_parts_ref(bottom, parts, feature_map) -> torch.Tensor:
    """Plain version of K2: stack z, round to bf16, f32 batched product with
    TF32 off, triu extraction."""
    return _interaction_ref(bottom, _mapped(parts, feature_map, bottom.shape[0]))


def dot_interaction_oh_parts_ref(bottom, arena, slots, scales, parts,
                                 feature_map) -> torch.Tensor:
    """Plain version of K3."""
    b = bottom.shape[0]
    feats = oh_rows_ref(arena, slots, scales, b) + _mapped(parts, feature_map, b)
    return _interaction_ref(bottom, feats)


# ----------------------------------------------------------------- kernels


def _bind(lib) -> None:
    global _bound
    if _bound:
        return
    lib.hps_dot_interaction.restype = ctypes.c_int
    lib.hps_dot_interaction.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_int,
    ]
    _bound = True


def _launch(name, bottom, parts, feature_map, oh=None) -> torch.Tensor:
    dev = bottom.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if bottom.dtype != torch.float32 or bottom.dim() != 2 or bottom.stride(1) != 1:
        raise ValueError(f"{name}: bottom must be f32 [B, D] with unit column stride")
    b, d = bottom.shape
    if len(feature_map) > MAX_FEATS:
        raise ValueError(f"{name}: at most {MAX_FEATS} fed features, got {len(feature_map)}")
    ptrs, strides = [], []
    for p, s in feature_map:
        part = parts[p]
        if (part.device != dev or part.dtype != torch.float32 or part.dim() != 3
                or part.shape[1] < b or part.shape[2] != d or part.stride(2) != 1
                or not 0 <= s < part.shape[0]):
            raise ValueError(
                f"{name}: part {p} must be f32 [n, >= {b}, {d}] on {dev} with "
                f"unit column stride and hold sub {s}; got {tuple(part.shape)} "
                f"{part.dtype} strides {part.stride()}")
        ptrs.append(part.data_ptr() + s * part.stride(0) * 4)
        strides.append(part.stride(1))
    vec4 = int(d % 4 == 0 and bottom.data_ptr() % 16 == 0 and bottom.stride(0) % 4 == 0
               and all(x % 16 == 0 for x in ptrs) and all(x % 4 == 0 for x in strides))
    n_oh, kind, arena_ptr, arena_rows = 0, 3, None, 0
    slots_ptr = scales_ptr = None
    slots_ld = scales_ld = 0
    if oh is not None:
        arena, slots, scales = oh
        n_oh = slots.shape[0]
        if arena.dtype not in _ARENA_KIND:
            raise TypeError(f"{name}: unsupported arena dtype {arena.dtype} "
                            "(nibble-packed int4 never takes the one-hot kind)")
        if (arena.device != dev or arena.dim() != 2 or arena.shape[1] != d
                or not arena.is_contiguous()):
            raise ValueError(f"{name}: arena must be a contiguous [R, {d}] tensor on {dev}")
        if (slots.device != dev or slots.dtype != torch.int32 or slots.dim() != 2
                or slots.shape[1] < b or slots.stride(1) != 1):
            raise ValueError(f"{name}: slots must be int32 [n_oh, >= {b}] on {dev}")
        if scales is not None and (
                scales.device != dev or scales.dtype != torch.float32
                or scales.shape[0] != n_oh or scales.shape[1] < b or scales.stride(1) != 1):
            raise ValueError(f"{name}: scales must be f32 [{n_oh}, >= {b}] on {dev}")
        kind, arena_ptr, arena_rows = _ARENA_KIND[arena.dtype], arena.data_ptr(), arena.shape[0]
        slots_ptr, slots_ld = slots.data_ptr(), slots.stride(0)
        if scales is not None:
            scales_ptr, scales_ld = scales.data_ptr(), scales.stride(0)
    f = 1 + n_oh + len(feature_map)
    out = torch.empty((b, d + f * (f - 1) // 2), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    lib = kernels.library("dot_interaction")
    _bind(lib)
    arr_t = ctypes.c_longlong * max(len(ptrs), 1)
    rc = lib.hps_dot_interaction(
        dev.index, kernels.stream_of(bottom), b, d, n_oh, len(ptrs),
        bottom.data_ptr(), bottom.stride(0), arr_t(*ptrs), arr_t(*strides),
        kind, arena_ptr, arena_rows, slots_ptr, slots_ld, scales_ptr,
        scales_ld, out.data_ptr(), vec4,
    )
    kernels.check(lib, rc, name)
    kernels.launches[name] += 1
    return out


def dot_interaction_parts(bottom: torch.Tensor, parts, feature_map) -> torch.Tensor:
    """K2. bottom [B, D] f32; parts: [n_i, S_i >= B, D] f32 (any strides with
    a unit column stride); feature_map[t] = (part, sub).
    -> [B, D + F(F-1)/2] f32 with F = 1 + len(feature_map)."""
    if bottom.device.type == "cpu":
        return dot_interaction_parts_ref(bottom, parts, feature_map)
    return _launch("dot_interaction_parts", bottom, parts, feature_map)


def dot_interaction_oh_parts(bottom: torch.Tensor, arena: torch.Tensor,
                             slots: torch.Tensor, scales: Optional[torch.Tensor],
                             parts, feature_map) -> torch.Tensor:
    """K3. As K2, with ``n_oh = slots.shape[0]`` features before the
    ``feature_map`` ones, built from ``arena`` [R, D] (int8, fp8, bf16 or
    f32): feature j of sample b is ``f32(arena[slots[j, b]]) * scales[j, b]``
    (``scales`` None -> 1), rounded to bf16 like every z row."""
    if bottom.device.type == "cpu":
        return dot_interaction_oh_parts_ref(bottom, arena, slots, scales, parts,
                                            feature_map)
    return _launch("dot_interaction_oh_parts", bottom, parts, feature_map,
                   oh=(arena, slots, scales))
