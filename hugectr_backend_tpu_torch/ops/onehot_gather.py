"""K6: the one-hot worklist gather over a small-table arena
(``csrc/onehot_gather.cu``).

Port of the JAX package's ``ops/onehot_gather.py``. Small tables live in one
arena, each member padded to ``r_tile`` rows and ``r_tile``-aligned; keys
arrive per member, each member's segment a whole number of ``m_tile`` key
tiles. A host-side plan lists one step per (key tile, row tile of that
member) pair: ``kt`` (key tile), ``rt`` (row tile) and ``first`` (1 on the
first step of a key tile's run).

Semantics, shared by the kernel and its plain version: key ``n`` lies in key
tile ``n // m_tile``; walk that tile's run of steps in plan order. At step
``s`` with ``r0 = rt[s] * r_tile``, the step's part is ``f32(values[slot])``
when ``r0 <= slot < r0 + r_tile`` and 0 otherwise (and, in v1, the scale
part ``scales[slot]`` or 0). The first step of a run assigns its part, later
steps add theirs. v1 (:func:`onehot_gather`) returns ``rows * svec``; v2
(:func:`onehot_gather_rows`) returns ``rows``. A slot that falls in none of
its tile's row tiles gives a zero row.

On the TPU the step is a one-hot matrix product on the MXU, which reads a
row tile sequentially. The port does not carry the product over: on Hopper
a gather of the one matching row moves far fewer bytes than the product
costs operations, so the kernel is a masked gather (see the ``.cu`` file).
It resolves each key's run once: the number of steps that hit and whether
one missed decide the result, since every step adds the same row or 0.
Where the two differ is a non-finite arena: the TPU product multiplies the
0/1 mask by the whole row tile, so one ``inf`` in a tile gives ``0 * inf =
NaN`` in its column for every key of the tile. The port follows the gather,
which is the contract the JAX docstrings state ("bit-identical to
gather_dequant_xla"): only a key whose own row holds the ``inf`` sees it.
The sign of a zero differs too: the product sums from +0, so the TPU body
gives +0.0 for a -0.0 value; the port's walk keeps -0.0 where every step of
the key's run hits (the first assigns the row, each later one adds it) and
gives +0.0 where a step missed (``-0.0 + 0.0``).

Plan validation (:func:`check_plan`) runs once per plan on the host and
raises ``ValueError`` for plans whose output the TPU leaves undefined (a key
tile's steps not consecutive, ``first`` not 1 exactly at the start of each
run, a key tile without a run, a row tile out of the arena, arena rows not a
multiple of ``r_tile``). The run offsets (CSR over key tiles) and ``rt`` are
uploaded once per (plan, arena rows, device), not on every call.

:func:`onehot_gather` and :func:`onehot_gather_rows` launch the kernel for
CUDA tensors and raise if they cannot; they take the plain versions only for
CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from hugectr_backend_tpu_torch.ops import kernels
from hugectr_backend_tpu_torch.ops.dequant_gather import (
    gather_dequant,
    gather_dequant_ref,
    k1_plan,
)

M_TILE = 512   # default keys per work-list row block
R_TILE = 512   # default table rows per work-list column block

# Tables with padded rows above this are left to the random-access gather
# (the JAX package's threshold, kept for callers that size arenas by it).
DEFAULT_MAX_ROWS = 8192

# Storage dtype -> the `kind` code of csrc/onehot_gather.cu.
_KIND = {
    torch.int8: 0,
    torch.float8_e4m3fn: 1,
    torch.bfloat16: 2,
    torch.float32: 3,
}

_bound = False


@dataclasses.dataclass(frozen=True)
class OnehotPlan:
    """Host-side work list for one arena-wide block-diagonal gather."""

    kt: np.ndarray     # [S] int32: output/slot key-tile index per step
    rt: np.ndarray     # [S] int32: table row-tile index per step
    first: np.ndarray  # [S] int32: 1 on the first step of each key tile
    num_key_tiles: int
    m_tile: int = M_TILE
    r_tile: int = R_TILE
    # (arena rows, device) -> the validated plan's arrays on that device.
    _uploads: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                       compare=False)

    @property
    def steps(self) -> int:
        return int(self.kt.shape[0])


def plan_onehot_worklist(
    member_row_tiles: "list[tuple[int, int]]",
    keys_per_member: "list[int]",
    m_tile: int = M_TILE,
    r_tile: int = R_TILE,
) -> OnehotPlan:
    """Build the work list.

    member_row_tiles: per member, (first_row_tile, num_row_tiles) in the
        arena's r_tile-tile coordinates.
    keys_per_member: number of query slots per member (each a multiple of
        m_tile); slots are laid out per-member-contiguously.
    """
    kt, rt, first = [], [], []
    key_tile = 0
    for (tile0, ntiles), nkeys in zip(member_row_tiles, keys_per_member,
                                      strict=True):
        if nkeys % m_tile:
            raise ValueError(f"keys per member must be a multiple of {m_tile}")
        if ntiles <= 0:
            raise ValueError("member must span at least one row tile")
        for _ in range(nkeys // m_tile):
            for j in range(ntiles):
                kt.append(key_tile)
                rt.append(tile0 + j)
                first.append(1 if j == 0 else 0)
            key_tile += 1
    return OnehotPlan(
        kt=np.asarray(kt, np.int32),
        rt=np.asarray(rt, np.int32),
        first=np.asarray(first, np.int32),
        num_key_tiles=key_tile,
        m_tile=m_tile,
        r_tile=r_tile,
    )


def check_plan(plan: OnehotPlan, arena_rows: int):
    """Validate ``plan`` against an arena of ``arena_rows`` rows.
    -> (run offsets [num_key_tiles + 1] int32, rt [S] int32 in run order,
    longest run): key tile ``k``'s steps are ``offsets[k]:offsets[k + 1]``."""
    kt, rt, first = (np.asarray(a) for a in (plan.kt, plan.rt, plan.first))
    if not (kt.ndim == 1 and kt.shape == rt.shape == first.shape):
        raise ValueError("plan arrays kt, rt and first must be 1-D and of one length")
    if plan.m_tile <= 0 or plan.r_tile <= 0:
        raise ValueError(f"m_tile {plan.m_tile} and r_tile {plan.r_tile} must be positive")
    if arena_rows % plan.r_tile:
        raise ValueError(f"arena rows {arena_rows} are not a multiple of r_tile {plan.r_tile}")
    nkt = plan.num_key_tiles
    if kt.size and (kt.min() < 0 or kt.max() >= nkt):
        raise ValueError(f"plan key tile out of [0, {nkt})")
    if rt.size and (rt.min() < 0 or rt.max() >= arena_rows // plan.r_tile):
        raise ValueError(f"plan row tile out of the arena's [0, {arena_rows // plan.r_tile})")
    starts = np.ones(kt.shape, bool)
    starts[1:] = kt[1:] != kt[:-1]
    run_kt = kt[starts]
    if np.unique(run_kt).size != run_kt.size:
        raise ValueError("the steps of a key tile are not consecutive in the plan")
    if run_kt.size != nkt:
        raise ValueError(f"{nkt - run_kt.size} of {nkt} key tiles have no steps in the plan")
    if not np.array_equal(first, starts.astype(first.dtype)):
        raise ValueError("plan first must be 1 exactly at the start of each key tile's run")
    counts = np.bincount(kt, minlength=nkt)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    order = np.argsort(kt, kind="stable")
    return offsets, rt[order].astype(np.int32), int(counts.max()) if nkt else 0


def _device_plan(plan: OnehotPlan, arena_rows: int, device: torch.device):
    """(offsets, rt, longest run) of :func:`check_plan`, the arrays on
    ``device``: validated and uploaded once per (plan, arena rows, device)."""
    key = (arena_rows, str(device))
    got = plan._uploads.get(key)
    if got is None:
        offsets, rt, longest = check_plan(plan, arena_rows)
        got = (torch.from_numpy(offsets).to(device), torch.from_numpy(rt).to(device), longest)
        plan._uploads[key] = got
    return got


def _check_call(values: torch.Tensor, slots: torch.Tensor, plan: OnehotPlan) -> None:
    if slots.shape[0] != plan.num_key_tiles * plan.m_tile:
        raise ValueError(
            f"slots length {slots.shape[0]} does not match the plan "
            f"({plan.num_key_tiles} x {plan.m_tile} keys) — member keys "
            "would be silently dropped"
        )
    if values.dtype == torch.uint8:
        raise TypeError(
            "one-hot lookup cannot consume nibble-packed int4 arenas; use "
            "the gather path (lookup_kind='arena'/'solo')"
        )
    if values.dtype not in _KIND:
        raise TypeError(f"onehot_gather: unsupported arena dtype {values.dtype}")
    if values.dim() != 2:
        raise ValueError("onehot_gather: values must be a [R_pad, D] tensor")


def _walk_ref(values, scales, slots, plan, scaled: bool) -> torch.Tensor:
    """The plain version of both bodies (see the module docstring)."""
    _check_call(values, slots, plan)
    n, d = slots.shape[0], values.shape[1]
    dev = values.device
    if n == 0:
        return torch.empty((0, d), dtype=torch.float32, device=dev)
    offsets, rt, longest = _device_plan(plan, values.shape[0], dev)
    slot = slots.long()
    tile = torch.arange(n, device=dev) // plan.m_tile
    start = offsets[tile].long()
    length = offsets[tile + 1].long() - start
    # Every candidate row, read once; a step selects it or 0.
    safe = slot.clamp(0, values.shape[0] - 1).to(torch.int32)
    row = gather_dequant_ref(values, None, safe)
    if scaled:
        srow = (scales.index_select(0, safe.long()) if scales is not None
                else torch.ones(n, dtype=torch.float32, device=dev))
    rows = svec = None
    for j in range(longest):
        live = j < length
        r0 = rt[(start + j).clamp(max=rt.shape[0] - 1)].long() * plan.r_tile
        hit = live & (slot >= r0) & (slot < r0 + plan.r_tile)
        part = torch.where(hit[:, None], row, 0.0)
        rows = part if j == 0 else torch.where(live[:, None], rows + part, rows)
        if scaled:
            spart = torch.where(hit, srow, 0.0)
            svec = spart if j == 0 else torch.where(live, svec + spart, svec)
    return rows * svec[:, None] if scaled else rows


def onehot_gather_ref(values: torch.Tensor, scales: Optional[torch.Tensor],
                      slots: torch.Tensor, plan: OnehotPlan) -> torch.Tensor:
    """Plain PyTorch version of K6 v1 (``_onehot_kernel``)."""
    return _walk_ref(values, scales, slots, plan, scaled=True)


def onehot_gather_rows_ref(values: torch.Tensor, slots: torch.Tensor,
                           plan: OnehotPlan) -> torch.Tensor:
    """Plain PyTorch version of K6 v2 (``_onehot_rows_kernel``)."""
    return _walk_ref(values, None, slots, plan, scaled=False)


def _bind(lib) -> None:
    global _bound
    if _bound:
        return
    lib.hps_onehot_gather.restype = ctypes.c_int
    lib.hps_onehot_gather.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    _bound = True


def _launch(values, scales, slots, plan, scaled: bool, name: str) -> torch.Tensor:
    _check_call(values, slots, plan)
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not values.is_contiguous():
        raise ValueError(f"{name}: values must be contiguous")
    if slots.dtype != torch.int32 or slots.dim() != 1 or not slots.is_contiguous():
        raise ValueError(f"{name}: slots must be a contiguous int32 [N] tensor")
    if scales is not None and (scales.dtype != torch.float32
                               or scales.shape != (values.shape[0],)
                               or not scales.is_contiguous()):
        raise ValueError(f"{name}: scales must be contiguous f32 [{values.shape[0]}]")
    for t in (slots, scales):
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one device")
    rows, d = values.shape
    n = slots.shape[0]
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n == 0 or d == 0:
        return out
    offsets, rt, _ = _device_plan(plan, rows, dev)
    # The piece path: rows of whole pieces of 4 elements, the arena aligned to one.
    vec = int(d % 4 == 0 and values.data_ptr() % (4 * values.element_size()) == 0)
    # The kernel walks keys as K1 walks rows: K1's plan for one group of n.
    kp = k1_plan([n], torch.cuda.get_device_properties(dev).multi_processor_count)
    lib = kernels.library("onehot_gather")
    _bind(lib)
    rc = lib.hps_onehot_gather(
        dev.index, kernels.stream_of(values), _KIND[values.dtype], values.data_ptr(), rows, d,
        slots.data_ptr(), n, offsets.data_ptr(), rt.data_ptr(), plan.m_tile, plan.r_tile,
        int(scaled), scales.data_ptr() if scales is not None else None, out.data_ptr(), vec,
        kp.rows, kp.units, kp.grid,
    )
    kernels.check(lib, rc, name)
    kernels.launches[name] += 1
    return out


def onehot_gather(values: torch.Tensor, scales: Optional[torch.Tensor],
                  slots: torch.Tensor, plan: OnehotPlan) -> torch.Tensor:
    """K6 v1. ``values`` [R_pad, D] int8 / float8_e4m3fn / bfloat16 /
    float32 arena (R_pad % r_tile == 0); ``scales`` [R_pad] f32 or None
    (ones); ``slots`` [N] int32 arena-global, per-member segments,
    N = num_key_tiles * m_tile. -> [N, D] f32 rows times the summed scales,
    bit-identical to ``gather_dequant(values, scales, slots)`` for slots
    inside their member's row tiles when each row tile is visited once."""
    if values.device.type == "cpu":
        return onehot_gather_ref(values, scales, slots, plan)
    return _launch(values, scales, slots, plan, True, "onehot_gather")


def onehot_gather_rows(values: torch.Tensor, slots: torch.Tensor,
                       plan: OnehotPlan) -> torch.Tensor:
    """K6 v2: rows only (the caller multiplies by per-key scales). -> [N, D]
    f32, bit-identical to ``values[slots].float()`` for slots inside their
    member's row tiles when each row tile is visited once."""
    if values.device.type == "cpu":
        return onehot_gather_rows_ref(values, slots, plan)
    return _launch(values, None, slots, plan, False, "onehot_gather_rows")


def verify_onehot_path(values, scales, plan: OnehotPlan, member_row_tiles,
                       rng_seed: int = 0, rows_only: bool = False) -> bool:
    """Run K6 once on random in-range slots (one key tile per member) and
    compare with K1 (:func:`gather_dequant`). -> True when bit-identical.
    The port has no other path to fall back to; this is a check only."""
    r = np.random.default_rng(rng_seed)
    parts = []
    for tile0, ntiles in member_row_tiles:
        base = tile0 * plan.r_tile
        parts.append(base + r.integers(0, ntiles * plan.r_tile, plan.m_tile))
    probe = plan_onehot_worklist(
        member_row_tiles, [plan.m_tile] * len(member_row_tiles),
        m_tile=plan.m_tile, r_tile=plan.r_tile,
    )
    slots = torch.from_numpy(np.concatenate(parts).astype(np.int32)).to(values.device)
    if rows_only:
        got = onehot_gather_rows(values, slots, probe)
        want = gather_dequant(values, None, slots)
    else:
        got = onehot_gather(values, scales, slots, probe)
        want = gather_dequant(values, scales, slots)
    return bool(torch.equal(got, want))
