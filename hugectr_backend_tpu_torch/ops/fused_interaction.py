"""K2 / K3 / K4: the fused DLRM dot interaction (``csrc/dot_interaction.cu``)
and its gradient (``csrc/dot_interaction_bwd.cu``).

``concat([bottom, triu(z z^T, 1)])`` with ``z = [bottom; features]``, z
rounded to bf16 and the products summed in f32 — what the JAX package's
Pallas bodies compute (its ops/fused_interaction.py:65, :298, :322, :620).
The forward takes f32 or bf16 (the DLRM's ``compute_dtype``): the bottom,
the fed features and the output share the bottom's type, and on bf16 the
f32 sums round to bf16 once, as the Pallas bodies write ``bottom.dtype``.
A one-hot group's arena keeps its storage type.

- K4 :func:`fused_dot_interaction`: the features are a stacked
  ``emb`` [B, T, D] (the training path and the single-table server), passed
  to the kernel as strided feature views.
- K2 :func:`dot_interaction_parts`: the features are rows of the lookup
  engine's chunked outputs (``parts[i]`` [n_i, S_i, D], S_i >= B), placed by
  ``feature_map[t] = (part, sub)``. Unmapped (phantom) rows are never read.
- K3 :func:`dot_interaction_oh_parts`: K2 whose first ``n_oh`` features are
  built in the kernel from a small quantized one-hot arena:
  ``bf16(f32(arena[slots[j, b]]) * scales[j, b])`` for a slot inside its
  member's rows, a zero row outside them (the Pallas body's one-hot mask).
  Forward-only, as in the JAX package: under autograd it raises.

K4 and K2 are ``torch.autograd.Function``s whose backward is the JAX
package's custom VJP (``_bwd`` :150, ``_bwd_parts`` :536): the pair
gradients scattered into a symmetric [F, F] matrix times the **f32** z (not
the forward's bf16 z), summed in f32. Each feature's gradient goes back to
its (part, sub); unmapped subs and rows past the batch get zero. The
backward kernel takes f32 only: a bf16 forward under autograd raises there.

The wrappers launch the kernels for CUDA tensors and raise if they cannot;
they take the plain versions (``*_ref``) only for CPU tensors. The launch
plans (:func:`k3_plan`, :func:`bwd_plan`) are plain Python. Past what the
kernels of the main path hold in shared memory or in their parameter block
(F = 688 forward at D = 128, 1,024 fed features or one-hot members; F =
147 backward), the plans pick each file's wide route: a kernel that keeps z
(forward) or S (backward) out of shared memory and reads its descriptors
from a device buffer, so F is bounded by device memory only. The host-side
helpers for feature orders (``is_part_major``, ``part_major_order``,
``interaction_permutation``, ``permute_top_mlp_kernel``) are copies of the
JAX package's.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from hugectr_backend_tpu_torch.ops import kernels

#: Fed features (and one-hot members) the main path's kernels take in their
#: parameter block: MAX_DESC in csrc/dot_interaction.cu, MAX_FEATS in
#: csrc/dot_interaction_bwd.cu. Past it the plans take the wide routes.
MAX_FEATS = 1024

#: The H100's streaming multiprocessors, the dynamic shared memory one block
#: may use and the shared memory of one SM (bytes): what :func:`bwd_plan`
#: and :func:`k3_plan` size their grids for.
H100_SMS = 132
MAX_SMEM = 232448
SM_SMEM = 233472
_BWD_THREADS = 128  # THREADS in csrc/dot_interaction_bwd.cu
_BWD_FT, _BWD_FG = 7, 8  # HPS_FT, HPS_FG there: rows of dz per thread, their stride in S
_K3_MAX_WARPS = 8  # MAX_WARPS in csrc/dot_interaction.cu
_K3_SM_WARPS = 16  # its __launch_bounds__(256, 2): at most 16 warps on an SM
_WIDE_THREADS, _WIDE_CTAS_PER_SM = 256, 2  # the forward's wide route
_WIDE_STAGE = 8 * 16 * 33 * 4  # WIDE_STAGE_BYTES there: its static shared memory
_BWD_WIDE_ROWS = 8  # WIDE_ROWS in csrc/dot_interaction_bwd.cu: rows of dz a thread
_BWD_WIDE_CTAS_PER_SM = 16  # 128-thread CTAs: 2,048 threads an SM

# Arena dtype -> the `arena_kind` code of csrc/dot_interaction.cu.
_ARENA_KIND = {
    torch.int8: 0,
    torch.float8_e4m3fn: 1,
    torch.bfloat16: 2,
    torch.float32: 3,
}

_bound = False
_bwd_bound = False
# (device, dtype, values) -> the values as a tensor on the device: the wide
# routes' descriptor tables, uploaded once and not inside a CUDA graph.
_tables: "collections.OrderedDict" = collections.OrderedDict()


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

    def astype(self, dtype) -> "EmbParts":
        """The parts cast to ``dtype``; the one-hot group keeps its types
        (quantized values, f32 scales), as the JAX package's ``astype``."""
        return EmbParts([p.to(dtype) for p in self.parts], self.feature_map, self.batch,
                        self.oh)


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
def full_f32_matmul():
    """f32 products in full f32 for the block: TF32 off, whatever the caller
    set (restored after)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _interaction_ref(bottom: torch.Tensor, feats) -> torch.Tensor:
    z = torch.stack([f.float() for f in [bottom, *feats]], dim=1)  # [B, F, D]
    z = z.to(torch.bfloat16).float()
    with full_f32_matmul():
        zzt = torch.bmm(z, z.transpose(1, 2))
    f = z.shape[1]
    r, c = torch.triu_indices(f, f, 1, device=z.device)
    return torch.cat([bottom, zzt[:, r, c].to(bottom.dtype)], dim=1)


def _mapped(parts, feature_map, batch):
    return [parts[p][s][:batch] for p, s in feature_map]


def oh_rows_ref(arena, slots, scales, batch, members=None):
    """The first ``batch`` one-hot features K3 builds, the plain way: a list
    of [batch, D] f32 rows ``f32(arena[slots[j]]) * scales[j]``, a zero row
    (``0 * scale``) where a slot lies outside its member's rows ``members[j]
    = (offset, size)``, as the Pallas body's one-hot mask gives, and a NaN
    row where it lies outside the arena, as the kernel writes. ``members``
    None: each member is the whole arena."""
    n_rows = arena.shape[0]
    rows = []
    for j in range(slots.shape[0]):
        sl = slots[j, :batch]
        off, size = members[j] if members is not None else (0, n_rows)
        inside = (sl >= off) & (sl < off + size)
        in_arena = (sl >= 0) & (sl < n_rows)
        idx = sl.long().clamp(0, max(n_rows - 1, 0))
        if arena.dtype == torch.float8_e4m3fn:
            r = arena.view(torch.uint8).index_select(0, idx).view(arena.dtype).float()
        else:
            r = arena.index_select(0, idx).float()
        r = r.masked_fill(~inside[:, None], 0.0)
        if scales is not None:
            r = r * scales[j, :batch][:, None]
        rows.append(r.masked_fill(~in_arena[:, None], float("nan")))
    return rows


def dot_interaction_parts_ref(bottom, parts, feature_map) -> torch.Tensor:
    """Plain version of K2: stack z, round to bf16, f32 batched product with
    TF32 off, triu extraction; the pairs rounded to the bottom's type."""
    return _interaction_ref(bottom, _mapped(parts, feature_map, bottom.shape[0]))


def fused_dot_interaction_ref(bottom, emb) -> torch.Tensor:
    """Plain version of K4's forward (``emb`` [B, T, D])."""
    return _interaction_ref(bottom, emb.unbind(1))


def fused_dot_interaction_bwd_ref(bottom, emb, g):
    """Plain version of K4's backward, line for line the JAX package's
    ``_bwd`` (ops/fused_interaction.py:154-167): the pair gradients
    scattered into a symmetric [B, F, F] adjoint, times the f32 z (TF32
    off). -> (g_bottom [B, D], g_emb [B, T, D])."""
    batch, dim = bottom.shape
    feats = emb.shape[1] + 1
    rows, cols = torch.triu_indices(feats, feats, 1, device=bottom.device)
    g_bot_direct = g[:, :dim]
    g_pairs = g[:, dim:].float()
    dzzt = torch.zeros((batch, feats, feats), dtype=torch.float32, device=bottom.device)
    dzzt[:, rows, cols] = g_pairs
    dzzt = dzzt + dzzt.transpose(1, 2)
    z = torch.cat([bottom[:, None, :], emb], dim=1).float()
    with full_f32_matmul():
        dz = torch.bmm(dzzt, z)
    g_bot = g_bot_direct + dz[:, 0, :].to(bottom.dtype)
    g_emb = dz[:, 1:, :].to(emb.dtype)
    return g_bot, g_emb


def dot_interaction_parts_bwd_ref(bottom, parts, feature_map, g):
    """Plain version of K2's backward, the JAX package's ``_bwd_parts``
    (:536-566): :func:`fused_dot_interaction_bwd_ref` on the stacked
    features, each feature's gradient routed back to its (part, sub).
    Unmapped subs and rows past the batch get zero; a (part, sub) named
    twice gets the gradient of its last feature, as there.
    -> (g_bottom, [g_part, ...])."""
    batch = bottom.shape[0]
    emb = torch.stack(_mapped(parts, feature_map, batch), dim=1)
    g_bot, g_emb = fused_dot_interaction_bwd_ref(bottom, emb, g)
    g_parts = [torch.zeros_like(p) for p in parts]
    for t, (p, s) in enumerate(feature_map):
        g_parts[p][s, :batch] = g_emb[:, t]
    return g_bot, g_parts


def dot_interaction_oh_parts_ref(bottom, arena, slots, scales, parts,
                                 feature_map, members=None) -> torch.Tensor:
    """Plain version of K3."""
    b = bottom.shape[0]
    feats = oh_rows_ref(arena, slots, scales, b, members) + _mapped(parts, feature_map, b)
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
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.hps_dot_interaction_wide.restype = ctypes.c_int
    lib.hps_dot_interaction_wide.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int,
    ]
    _bound = True


def _device_table(rows, dtype, dev) -> torch.Tensor:
    """``rows`` (a list of equal-length tuples) as a ``dtype`` tensor on
    ``dev``, kept for later calls with the same contents: a table is its
    contents, so a hit is always right, and a CUDA graph that captures the
    call replays no host copy."""
    key = (str(dev), dtype, tuple(rows))
    got = _tables.get(key)
    if got is None:
        got = torch.tensor(rows, dtype=dtype).to(dev)
        _tables[key] = got
        if len(_tables) > 32:
            _tables.popitem(last=False)
    else:
        _tables.move_to_end(key)
    return got


class K3Plan(NamedTuple):
    """How the forward interaction kernel (K2, K3, K4) runs: CTAs of
    ``warps`` warps (the samples a CTA holds: a warp per sample at a time),
    ``smem`` bytes of dynamic shared memory a CTA (a z tile and a stage per
    warp), ``grid`` persistent CTAs, of which ``ctas_per_sm`` fit on an
    SM."""

    warps: int
    smem: int
    grid: int
    ctas_per_sm: int


def k3_stage_len(feats: int, dim: int) -> int:
    """Floats of one warp's stage: the first row block of the output (the
    bottom copy and the pairs of rows 0..15, the largest block) and 3 of
    alignment, rounded up to 4 (``stage_len`` in csrc/dot_interaction.cu)."""
    r1 = min(feats - 1, 16)
    return (3 + dim + r1 * (2 * feats - r1 - 1) // 2 + 3) // 4 * 4


def k3_warp_bytes(feats: int, dim: int) -> int:
    """Shared memory of one warp: the bf16 z tile (F and D padded to 16,
    rows 16 bytes longer) and the stage."""
    d_pad, f_pad = -(-dim // 16) * 16, -(-feats // 16) * 16
    return f_pad * (d_pad + 8) * 2 + 4 * k3_stage_len(feats, dim)


class K3WidePlan(NamedTuple):
    """The forward's wide route: ``grid`` persistent CTAs of ``threads``,
    each with its own bf16 z tile of ``f_pad`` rows (F and D rounded up to
    16, rows ``d_pad`` + 8 long): ``smem`` bytes of dynamic shared memory,
    or, where the tile does not fit a block's, 0 and a device scratch."""

    grid: int
    threads: int
    f_pad: int
    d_pad: int
    smem: int


def k3_plan(batch: int, feats: int, dim: int, sms: int = H100_SMS,
            descs: Optional[int] = None):
    """The forward kernel's launch plan for B = ``batch``, F = ``feats`` (the
    bottom, the one-hot and the fed features) and D = ``dim`` on a card of
    ``sms`` SMs: the warps per CTA (up to 8) and CTAs per SM (up to 16 warps
    an SM, 128 registers a thread) that keep the most warps resident, more
    warps a CTA on a tie, and a grid of no more CTAs than fit on the card
    at once (a persistent grid), nor than the batch needs. Where one
    sample's tile does not fit a block's shared memory, or ``descs`` (the
    larger of the fed features and the one-hot members; by default every
    feature but the bottom) passes MAX_FEATS: a :class:`K3WidePlan`, its
    z tile in shared memory where it fits (up to 2 CTAs of 256 threads per
    SM), else in device memory (2 CTAs per SM); no more CTAs than the batch
    needs."""
    if batch < 0 or feats < 1 or dim < 1:
        raise ValueError(f"k3_plan: no plan for B {batch}, F {feats}, D {dim}")
    per_warp = k3_warp_bytes(feats, dim)
    if per_warp > MAX_SMEM or (feats - 1 if descs is None else descs) > MAX_FEATS:
        f_pad, d_pad = -(-feats // 16) * 16, -(-dim // 16) * 16
        tile = 2 * f_pad * (d_pad + 8)
        smem = tile if tile <= MAX_SMEM - _WIDE_STAGE else 0
        per_sm = (min(_WIDE_CTAS_PER_SM, SM_SMEM // (tile + _WIDE_STAGE + 1024)) if smem
                  else _WIDE_CTAS_PER_SM)
        return K3WidePlan(max(1, min(batch, per_sm * sms)), _WIDE_THREADS, f_pad, d_pad, smem)
    best = None
    for warps in range(1, min(_K3_MAX_WARPS, MAX_SMEM // per_warp) + 1):
        smem = warps * per_warp
        per_sm = min(_K3_SM_WARPS // warps, SM_SMEM // (smem + 1024))
        if best is None or per_sm * warps >= best[0]:
            best = (per_sm * warps, warps, smem, per_sm)
    _, warps, smem, per_sm = best
    return K3Plan(warps, smem, max(1, min(-(-batch // warps), per_sm * sms)), per_sm)


def _feature_descs(name, bottom, parts, feature_map, dtypes=(torch.float32, torch.bfloat16)):
    """Check the CUDA operands of the interaction kernels: the bottom of one
    of ``dtypes``, every mapped part of the bottom's. -> (per feature row
    pointers, per feature batch strides, vec4: every z row starts on a
    4-value boundary with D % 4 == 0)."""
    dev = bottom.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    dt = bottom.dtype
    kinds = " or ".join(str(x).replace("torch.", "") for x in dtypes)
    if dt not in dtypes or bottom.dim() != 2 or bottom.stride(1) != 1:
        raise ValueError(f"{name}: bottom must be {kinds} [B, D] with unit column stride, "
                         f"got {dt} {tuple(bottom.shape)}")
    b, d = bottom.shape
    es = bottom.element_size()
    ptrs, strides = [], []
    for p, s in feature_map:
        part = parts[p]
        if (part.device != dev or part.dtype != dt or part.dim() != 3
                or part.shape[1] < b or part.shape[2] != d or part.stride(2) != 1
                or not 0 <= s < part.shape[0]):
            raise ValueError(
                f"{name}: part {p} must be {dt} [n, >= {b}, {d}] (the bottom's type) on "
                f"{dev} with unit column stride and hold sub {s}; got "
                f"{tuple(part.shape)} {part.dtype} strides {part.stride()}")
        ptrs.append(part.data_ptr() + s * part.stride(0) * es)
        strides.append(part.stride(1))
    vec4 = int(d % 4 == 0 and bottom.data_ptr() % (4 * es) == 0 and bottom.stride(0) % 4 == 0
               and all(x % (4 * es) == 0 for x in ptrs) and all(x % 4 == 0 for x in strides))
    return ptrs, strides, vec4


def _launch(name, bottom, parts, feature_map, oh=None, plan=None) -> torch.Tensor:
    """The forward kernel on CUDA operands; ``oh`` = (arena, slots, scales,
    members or None) for K3. ``plan``: :func:`k3_plan`'s, or a timing
    sweep's (the kernel checks it)."""
    dev = bottom.device
    ptrs, strides, vec4 = _feature_descs(name, bottom, parts, feature_map)
    b, d = bottom.shape
    n_oh, kind, arena_ptr, arena_rows, oh_vec = 0, 3, None, 0, 0
    slots_ptr = scales_ptr = None
    slots_ld = scales_ld = 0
    offs, sizes = [], []
    if oh is not None:
        arena, slots, scales, members = oh
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
        rows = arena.shape[0]
        members = [(0, rows)] * n_oh if members is None else [tuple(m) for m in members]
        if len(members) != n_oh or any(not (0 <= o <= o + sz <= rows) for o, sz in members):
            raise ValueError(f"{name}: {n_oh} members (offset, size) inside the arena's "
                             f"{rows} rows expected, got {members}")
        offs, sizes = [o for o, _ in members], [sz for _, sz in members]
        kind, arena_ptr, arena_rows = _ARENA_KIND[arena.dtype], arena.data_ptr(), rows
        oh_vec = int(d * arena.element_size() % 16 == 0 and arena.data_ptr() % 16 == 0)
        slots_ptr, slots_ld = slots.data_ptr(), slots.stride(0)
        if scales is not None:
            scales_ptr, scales_ld = scales.data_ptr(), scales.stride(0)
    f = 1 + n_oh + len(feature_map)
    io_bf16 = int(bottom.dtype == torch.bfloat16)
    out = torch.empty((b, d + f * (f - 1) // 2), dtype=bottom.dtype, device=dev)
    if b == 0:
        return out
    if plan is None:
        plan = k3_plan(b, f, d, torch.cuda.get_device_properties(dev).multi_processor_count,
                       max(len(ptrs), n_oh))
    lib = kernels.library("dot_interaction")
    _bind(lib)
    if isinstance(plan, K3WidePlan):
        fed = _device_table([(bottom.data_ptr(), bottom.stride(0))] + list(zip(ptrs, strides)),
                            torch.int64, dev)
        mem = _device_table(list(zip(offs, sizes)), torch.int32, dev) if n_oh else None
        scratch = (None if plan.smem else torch.empty(
            plan.grid * plan.f_pad * (plan.d_pad + 8), dtype=torch.bfloat16, device=dev))
        rc = lib.hps_dot_interaction_wide(
            dev.index, kernels.stream_of(bottom), b, d, n_oh, 1 + len(ptrs), fed.data_ptr(),
            kind, arena_ptr, arena_rows, slots_ptr, slots_ld, scales_ptr, scales_ld,
            None if mem is None else mem.data_ptr(), out.data_ptr(), io_bf16,
            None if scratch is None else scratch.data_ptr(), plan.grid, plan.smem)
        kernels.check(lib, rc, name)
        kernels.count_launch(name)
        return out
    arr_t = ctypes.c_longlong * max(len(ptrs), 1)
    int_t = ctypes.c_int * max(n_oh, 1)
    rc = lib.hps_dot_interaction(
        dev.index, kernels.stream_of(bottom), b, d, n_oh, len(ptrs),
        bottom.data_ptr(), bottom.stride(0), arr_t(*ptrs), arr_t(*strides),
        kind, arena_ptr, arena_rows, slots_ptr, slots_ld, scales_ptr,
        scales_ld, int_t(*offs), int_t(*sizes), out.data_ptr(), io_bf16, vec4, oh_vec,
        plan.warps, plan.grid, plan.smem,
    )
    kernels.check(lib, rc, name)
    kernels.count_launch(name)
    return out


class BwdPlan(NamedTuple):
    """How the backward kernel runs: ``stages`` of its cp.async ring, ``dc``
    columns of D per work item (a sample's slice), ``grid`` persistent CTAs
    of ``threads``, ``smem`` bytes of dynamic shared memory each, of which
    ``ctas_per_sm`` fit on an SM."""

    stages: int
    dc: int
    grid: int
    threads: int
    smem: int
    ctas_per_sm: int


def _up4(n: int) -> int:
    return (n + 3) // 4 * 4


def bwd_smem(feats: int, dc: int, stages: int) -> int:
    """Dynamic shared memory of the backward kernel for ``feats`` = F rows of
    z: S (F x 8 ceil(F / 7) f32), the table of the F(F-1)/2 pairs' positions
    in S, and ``stages`` ring stages of (the pair gradients, ``dc`` direct
    values, F x ``dc`` of z)."""
    sld = -(-feats // _BWD_FT) * _BWD_FG
    pairs = feats * (feats - 1) // 2
    stage = _up4(_up4(pairs + dc) + feats * dc)
    return 4 * (_up4(feats * sld) + _up4(pairs) + stages * stage)


class BwdWidePlan(NamedTuple):
    """The backward's wide route: ``grid`` CTAs of ``threads``, a thread per
    (sample, column, group of ``rows`` rows of dz), grid-stride."""

    grid: int
    threads: int
    rows: int


def bwd_plan(batch: int, dim: int, n_feats: int, sms: int = H100_SMS):
    """The backward kernel's launch plan for B = ``batch``, D = ``dim`` and
    ``n_feats`` fed features (F = n_feats + 1) on a card of ``sms`` SMs: the
    widest column slice (up to 128) with a 3-stage ring, else 2 stages,
    else narrower slices, that fits the shared memory of a block; as many
    CTAs as fit on an SM, times the SMs, but no more than work items. Past
    MAX_FEATS features, 16-bit positions in S or the shared memory of a
    block (F = 147): a :class:`BwdWidePlan`, as many CTAs as the work needs
    up to 16 per SM."""
    if n_feats < 0 or dim < 1 or batch < 0:
        raise ValueError(f"bwd_plan: no plan for B {batch}, D {dim}, {n_feats} features")
    feats = n_feats + 1
    if n_feats <= MAX_FEATS and feats * (-(-feats // _BWD_FT) * _BWD_FG) <= 65536:
        first = min(dim, 128)
        for dc in [first] + [c for c in (64, 32, 16, 8, 4) if c < first]:
            for stages in (3, 2):
                smem = bwd_smem(feats, dc, stages)
                if smem <= MAX_SMEM:
                    per_sm = min(2048 // _BWD_THREADS, SM_SMEM // (smem + 1024))
                    items = batch * -(-dim // dc)
                    return BwdPlan(stages, dc, max(1, min(items, per_sm * sms)), _BWD_THREADS,
                                   smem, per_sm)
    items = batch * -(-feats // _BWD_WIDE_ROWS) * dim  # at most: 4 columns a thread on vec4
    return BwdWidePlan(max(1, min(-(-items // _BWD_THREADS), _BWD_WIDE_CTAS_PER_SM * sms)),
                       _BWD_THREADS, _BWD_WIDE_ROWS)


def _bind_bwd(lib) -> None:
    global _bwd_bound
    if _bwd_bound:
        return
    lib.hps_dot_interaction_bwd.restype = ctypes.c_int
    lib.hps_dot_interaction_bwd.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.hps_dot_interaction_bwd_wide.restype = ctypes.c_int
    lib.hps_dot_interaction_bwd_wide.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ]
    _bwd_bound = True


def dot_interaction_bwd(bottom, parts, feature_map, g, need_bottom: bool = True,
                        need_parts=None):
    """The backward of K2 / K4 (the kernel of ``csrc/dot_interaction_bwd.cu``;
    its plain version :func:`dot_interaction_parts_bwd_ref` for CPU
    tensors). ``g`` [B, D + P] is the gradient of the interaction's output;
    ``need_bottom`` / ``need_parts[i]`` say which gradients to compute.
    -> (g_bottom or None, [g_part or None, ...]). A part's gradient is zero
    on unmapped subs and rows past the batch."""
    need_parts = [True] * len(parts) if need_parts is None else list(need_parts)
    if bottom.device.type == "cpu":
        g_bottom, g_parts = dot_interaction_parts_bwd_ref(bottom, parts, feature_map, g)
        return (g_bottom if need_bottom else None,
                [gp if need else None for gp, need in zip(g_parts, need_parts)])
    name = "dot_interaction_bwd"
    g = g.contiguous()
    ptrs, strides, vec4 = _feature_descs(name, bottom, parts, feature_map, (torch.float32,))
    dev = bottom.device
    b, d = bottom.shape
    n = len(feature_map)
    if (g.device != dev or g.dtype != torch.float32 or g.dim() != 2
            or tuple(g.shape) != (b, d + (n + 1) * n // 2) or g.stride(1) != 1):
        raise ValueError(f"{name}: the output gradient must be f32 [{b}, "
                         f"{d + (n + 1) * n // 2}] on {dev}, got {tuple(g.shape)} {g.dtype}")
    g_bottom = torch.empty((b, d), dtype=torch.float32, device=dev) if need_bottom else None
    # A part's gradient starts as zeros unless the kernel writes every row of
    # it (all subs mapped, no rows past the batch).
    mapped = {}
    for t, ps in enumerate(feature_map):
        mapped[ps] = t  # a (part, sub) named twice takes its last feature's gradient
    g_parts = []
    for i, part in enumerate(parts):
        if not need_parts[i]:
            g_parts.append(None)
            continue
        covered = part.shape[1] == b and all((i, s) in mapped for s in range(part.shape[0]))
        g_parts.append(torch.empty_like(part) if covered else torch.zeros_like(part))
    gptrs, gstrides = [], []
    for t, (p, s) in enumerate(feature_map):
        gp = g_parts[p]
        if gp is None or mapped[(p, s)] != t:
            gptrs.append(0)
            gstrides.append(0)
        else:
            gptrs.append(gp.data_ptr() + s * gp.stride(0) * 4)
            gstrides.append(gp.stride(1))
    if max(strides + gstrides, default=0) >= 2 ** 31:
        raise ValueError(f"{name}: a feature's batch stride does not fit 31 bits")
    if b == 0:
        return g_bottom, g_parts
    # The 16-byte path also stores the gradients a float4 at a time.
    vec4 = int(vec4 and all(x % 16 == 0 for x in gptrs) and all(x % 4 == 0 for x in gstrides))
    plan = bwd_plan(b, d, n,
                    torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = kernels.library("dot_interaction_bwd")
    _bind_bwd(lib)
    if isinstance(plan, BwdWidePlan):
        desc = (_device_table(list(zip(ptrs, strides, gptrs, gstrides)), torch.int64, dev)
                if n else None)
        rc = lib.hps_dot_interaction_bwd_wide(
            dev.index, kernels.stream_of(bottom), b, d, n, bottom.data_ptr(), bottom.stride(0),
            None if desc is None else desc.data_ptr(), g.data_ptr(), g.stride(0),
            g_bottom.data_ptr() if g_bottom is not None else None, d, vec4, plan.grid)
        kernels.check(lib, rc, name)
        kernels.count_launch(name)
        return g_bottom, g_parts
    arr_t = ctypes.c_longlong * max(n, 1)
    rc = lib.hps_dot_interaction_bwd(
        dev.index, kernels.stream_of(bottom), b, d, n, bottom.data_ptr(), bottom.stride(0),
        arr_t(*ptrs), arr_t(*strides), g.data_ptr(), g.stride(0),
        g_bottom.data_ptr() if g_bottom is not None else None, d,
        arr_t(*gptrs), arr_t(*gstrides), vec4, plan.stages, plan.dc, plan.grid, plan.smem,
    )
    kernels.check(lib, rc, name)
    kernels.count_launch(name)
    return g_bottom, g_parts


class _Interaction(torch.autograd.Function):
    """K4 / K2 with their gradient. ``name`` is the launch counter of the
    forward kernel; the backward kernel counts under
    ``dot_interaction_bwd``."""

    @staticmethod
    def forward(ctx, name, feature_map, bottom, *parts):
        ctx.feature_map = feature_map
        ctx.save_for_backward(bottom, *parts)
        if bottom.device.type == "cpu":
            return dot_interaction_parts_ref(bottom, parts, feature_map)
        return _launch(name, bottom, parts, feature_map)

    @staticmethod
    def backward(ctx, g):
        bottom, *parts = ctx.saved_tensors
        g_bottom, g_parts = dot_interaction_bwd(bottom, parts, ctx.feature_map, g,
                                                ctx.needs_input_grad[2],
                                                ctx.needs_input_grad[3:])
        return (None, None, g_bottom, *g_parts)


def fused_dot_interaction(bottom: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """K4. bottom [B, D] f32 or bf16, emb [B, T, D] of the same type (unit
    column stride) -> [B, D + F(F-1)/2] of that type with F = T + 1;
    differentiable in both inputs (f32 only: the backward kernel is f32)."""
    if emb.dim() != 3 or emb.shape[0] != bottom.shape[0] or emb.shape[2] != bottom.shape[-1]:
        raise ValueError(f"fused_dot_interaction: emb must be [B, T, D] for bottom "
                         f"{tuple(bottom.shape)}, got {tuple(emb.shape)}")
    fmap = tuple((0, t) for t in range(emb.shape[1]))
    return _Interaction.apply("fused_dot_interaction", fmap, bottom, emb.transpose(0, 1))


def fused_dot_interaction_bwd(bottom: torch.Tensor, emb: torch.Tensor, g: torch.Tensor):
    """K4's backward: the kernel for CUDA tensors, for CPU tensors its plain
    version (:func:`fused_dot_interaction_bwd_ref`). -> (g_bottom [B, D],
    g_emb [B, T, D])."""
    fmap = tuple((0, t) for t in range(emb.shape[1]))
    g_bottom, (g_emb,) = dot_interaction_bwd(bottom, [emb.transpose(0, 1)], fmap, g)
    return g_bottom, g_emb.transpose(0, 1)


def dot_interaction_parts(bottom: torch.Tensor, parts, feature_map) -> torch.Tensor:
    """K2. bottom [B, D] f32 or bf16; parts: [n_i, S_i >= B, D] of the same
    type (any strides with a unit column stride); feature_map[t] = (part,
    sub). -> [B, D + F(F-1)/2] of that type with F = 1 + len(feature_map);
    differentiable in bottom and the parts (f32 only)."""
    fmap = tuple(tuple(x) for x in feature_map)
    return _Interaction.apply("dot_interaction_parts", fmap, bottom, *parts)


def dot_interaction_oh_parts(bottom: torch.Tensor, arena: torch.Tensor,
                             slots: torch.Tensor, scales: Optional[torch.Tensor],
                             parts, feature_map, members=None) -> torch.Tensor:
    """K3. As K2 (f32 or bf16 bottom, parts and output), with ``n_oh =
    slots.shape[0]`` features before the ``feature_map`` ones, built from
    ``arena`` [R, D] (int8, fp8, bf16 or f32, whatever the bottom's type):
    feature j of sample b is ``f32(arena[slots[j, b]]) * scales[j, b]``
    (``scales`` None -> 1), rounded to bf16 like every z row, where the slot
    lies inside ``members[j] = (offset, size)``; outside it the row is zero,
    as the JAX package's one-hot mask gives (``members`` None: the whole
    arena), and outside the arena NaN. Forward-only: raises when autograd
    would record it."""
    kernels.forward_only("dot_interaction_oh_parts", bottom, arena, scales, *parts)
    if bottom.device.type == "cpu":
        return dot_interaction_oh_parts_ref(bottom, arena, slots, scales, parts,
                                            feature_map, members)
    return _launch("dot_interaction_oh_parts", bottom, parts, feature_map,
                   oh=(arena, slots, scales, members))
