"""K1: embedding gather + dequantize (``csrc/gather_dequant.cu``).

``out[n] = f32(values[slots[n]]) * s[n]`` with ``s`` the device scale of the
row (``scales[slots[n]]``), a host-gathered per-key scale (``scin[n]``) or 1.
This is the semantics of the JAX package's ``gather_rows_for_groups``
(``gather_dequant_xla``, then the ``scin`` multiply), and the one kernel
serves the arena, solo and one-hot lookup kinds: an int8 one-hot product is
exact, so a gather of the member's rows gives the same bits, and a slot
outside its member gives a zero row, as the product's all-zero mask does.

:func:`gather_dequant_groups` gathers every group of a lookup in one launch
(the JAX package jits them into one program); :func:`gather_dequant` is
the same kernel on one table. Both launch the kernel for CUDA tensors and
raise if they cannot; they take the plain versions,
:func:`gather_dequant_groups_ref` and :func:`gather_dequant_ref`, only for
CPU tensors. :func:`k1_plan` is the launch plan.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from hugectr_backend_tpu_torch.ops import kernels

# Storage dtype -> the `kind` code of csrc/gather_dequant.cu.
_KIND = {
    torch.int8: 0,
    torch.float8_e4m3fn: 1,
    torch.bfloat16: 2,
    torch.float32: 3,
    torch.uint8: 4,  # nibble-packed int4
}

_bound = False


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[N, D//2] packed uint8 -> [N, D] f32 (even columns = low nibble)."""
    lo = (packed & 0xF).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], packed.shape[1] * 2).float()


def _take_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if values.dtype == torch.float8_e4m3fn:
        # Gather the raw bytes: index_select has no fp8 kernel on every device.
        return values.view(torch.uint8).index_select(0, idx).view(values.dtype)
    return values.index_select(0, idx)


def gather_dequant_ref(values: torch.Tensor, scales: Optional[torch.Tensor],
                       slots: torch.Tensor,
                       scin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K1: index_select + cast + multiply."""
    _check_scales(scales, scin)
    idx = slots.long()
    rows = _take_rows(values, idx)
    out = unpack_int4(rows) if rows.dtype == torch.uint8 else rows.float()
    if scales is not None:
        out = out * scales.index_select(0, idx)[:, None]
    if scin is not None:
        out = out * scin[:, None]
    return out


def _check_scales(scales, scin) -> None:
    if scales is not None and scin is not None:
        raise ValueError("pass device scales or per-key scales, not both")


#: The H100's streaming multiprocessors: what :func:`k1_plan` sizes the
#: persistent grid for.
H100_SMS = 132
_THREADS, _WARPS = 256, 8  # THREADS, WARPS in csrc/gather_dequant.cu
_CTAS_PER_SM = 3           # its __launch_bounds__(THREADS, 3)
MAX_GROUPS = 256           # MAX_GROUPS there: descriptors in one launch
#: Bytes of a piece of 4 outputs per storage dtype (the vector path).
_PIECE = {torch.int8: 4, torch.float8_e4m3fn: 4, torch.bfloat16: 8, torch.float32: 16,
          torch.uint8: 2}


class K1Plan(NamedTuple):
    """How K1 runs a lookup: ``grid`` persistent CTAs of ``threads``;
    units of ``rows`` rows of one group (a power of two, 4 to 32), numbered
    group after group, ``units`` in all; a warp walks the units ``w, w +
    warps, ...``."""

    grid: int
    threads: int
    rows: int
    units: int


def k1_plan(group_rows: Sequence[int], sms: int = H100_SMS) -> K1Plan:
    """The launch plan of K1 for groups of ``group_rows`` rows (each >= 1)
    on a card of ``sms`` SMs: the smallest units (a power of two rows, 4 to
    32; 2 and 1 measured slower on one 4,096-key table) that leave no more
    units than warps the card holds at once (3 CTAs of 8 warps per SM), so
    that a small lookup spreads over every SM and a large one over every
    warp; a warp per unit, and as many CTAs as the units need, but no more
    than fit on the card at once."""
    if len(group_rows) > MAX_GROUPS:
        raise ValueError(f"k1_plan: at most {MAX_GROUPS} groups in one launch, "
                         f"got {len(group_rows)}")
    if any(n < 1 for n in group_rows):
        raise ValueError(f"k1_plan: every group needs a row, got {list(group_rows)}")
    slots = _CTAS_PER_SM * sms * _WARPS
    rows = 4
    while rows < 32 and sum(-(-n // rows) for n in group_rows) > slots:
        rows *= 2
    units = sum(-(-n // rows) for n in group_rows)
    return K1Plan(min(-(-units // _WARPS), _CTAS_PER_SM * sms), _THREADS, rows, units)


class _Group(ctypes.Structure):
    """``HpsGroup`` in csrc/gather_dequant.cu."""

    _fields_ = [
        ("values", ctypes.c_void_p), ("dscales", ctypes.c_void_p), ("scin", ctypes.c_void_p),
        ("rows", ctypes.c_longlong), ("lo", ctypes.c_longlong), ("hi", ctypes.c_longlong),
        ("slot0", ctypes.c_longlong), ("out_off", ctypes.c_longlong),
        ("n", ctypes.c_int), ("kind", ctypes.c_int), ("width", ctypes.c_int),
        ("dim", ctypes.c_int), ("vec", ctypes.c_int), ("rpu", ctypes.c_int),
        ("unit0", ctypes.c_int),
    ]


class _Spec(NamedTuple):
    """One descriptor of a launch: ``n`` rows of ``values`` from slot
    ``slot0`` on, the member's slots ``[lo, hi)``, the scale pointers (0:
    none) and the first output element."""

    values: torch.Tensor
    dscales: int
    scin: int
    lo: int
    hi: int
    slot0: int
    n: int
    out_off: int


def _out_dim(values: torch.Tensor) -> int:
    return values.shape[1] * 2 if values.dtype == torch.uint8 else values.shape[1]


def _check_values(name: str, values: torch.Tensor, dev) -> None:
    if values.dtype not in _KIND:
        raise TypeError(f"{name}: unsupported table dtype {values.dtype}")
    if values.dim() != 2 or not values.is_contiguous() or values.device != dev:
        raise ValueError(f"{name}: values must be a contiguous [R, W] tensor on {dev}")


def _check_f32(name: str, what: str, t: Optional[torch.Tensor], n: int, dev) -> None:
    if t is not None and (t.dtype != torch.float32 or t.shape != (n,)
                          or not t.is_contiguous() or t.device != dev):
        raise ValueError(f"{name}: {what} must be contiguous f32 [{n}] on {dev}")


def _check_slots(name: str, slots: torch.Tensor, dev) -> None:
    if (slots.dtype != torch.int32 or slots.dim() != 1 or not slots.is_contiguous()
            or slots.device != dev):
        raise ValueError(f"{name}: slots must be a contiguous int32 [N] tensor on {dev}")


def _bind(lib) -> None:
    global _bound
    if _bound:
        return
    lib.hps_gather_dequant_groups.restype = ctypes.c_int
    lib.hps_gather_dequant_groups.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(_Group), ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    _bound = True


def _launch(slots: torch.Tensor, out: torch.Tensor, specs: "list[_Spec]") -> None:
    """One launch of the kernel over ``specs`` (non-empty groups)."""
    if not specs:
        return
    dev = slots.device
    descs = (_Group * len(specs))()
    plan = k1_plan([sp.n for sp in specs],
                   torch.cuda.get_device_properties(dev).multi_processor_count)
    unit0 = 0
    for d, sp in zip(descs, specs):
        v = sp.values
        d.values, d.dscales, d.scin = v.data_ptr(), sp.dscales or None, sp.scin or None
        d.rows, d.lo, d.hi, d.slot0, d.out_off = v.shape[0], sp.lo, sp.hi, sp.slot0, sp.out_off
        d.n, d.kind, d.width, d.dim = sp.n, _KIND[v.dtype], v.shape[1], _out_dim(v)
        d.vec = int(d.dim % 4 == 0 and v.data_ptr() % _PIECE[v.dtype] == 0)
        d.rpu, d.unit0 = plan.rows, unit0
        unit0 += -(-sp.n // plan.rows)
    lib = kernels.library("gather_dequant")
    _bind(lib)
    rc = lib.hps_gather_dequant_groups(dev.index, kernels.stream_of(slots), slots.data_ptr(),
                                       out.data_ptr(), descs, len(specs), plan.units, plan.grid)
    kernels.check(lib, rc, "gather_dequant")
    kernels.count_launch("gather_dequant")


def gather_dequant(values: torch.Tensor, scales: Optional[torch.Tensor],
                   slots: torch.Tensor,
                   scin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1 on one table. ``values`` [R, W] int8 / float8_e4m3fn / bfloat16 /
    float32, or uint8 nibble-packed int4 (W = D/2); ``scales`` [R] f32 or
    None; ``slots`` [N] int32 in [0, R); ``scin`` [N] f32 or None.
    -> [N, D] f32.

    Slots are checked on the host before upload (cache/lookup_program.py);
    the kernel writes a NaN row for a slot out of range. Forward-only: raises
    when autograd would record it (parallel/sharded_table.py wraps it in a
    backward for tables that train)."""
    kernels.forward_only("gather_dequant", values, scales, scin)
    if values.device.type == "cpu":
        return gather_dequant_ref(values, scales, slots, scin)
    _check_scales(scales, scin)
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"gather_dequant: unsupported device {dev}")
    _check_values("gather_dequant", values, dev)
    _check_slots("gather_dequant", slots, dev)
    n = slots.shape[0]
    _check_f32("gather_dequant", "scales", scales, values.shape[0], dev)
    _check_f32("gather_dequant", "scin", scin, n, dev)
    out = torch.empty((n, _out_dim(values)), dtype=torch.float32, device=dev)
    if n and values.shape[1]:
        _launch(slots, out, [_Spec(values, scales.data_ptr() if scales is not None else 0,
                                   scin.data_ptr() if scin is not None else 0,
                                   0, values.shape[0], 0, n, 0)])
    return out


def _member_rows_ref(values: torch.Tensor, lo: int, hi: int,
                     slots: torch.Tensor) -> torch.Tensor:
    """f32 rows of one one-hot member: a slot outside ``[lo, hi)`` gives a
    zero row (the one-hot product's all-zero mask), one outside the table a
    NaN row, as the kernel writes."""
    in_table = (slots >= 0) & (slots < values.shape[0])
    inside = (slots >= lo) & (slots < hi)
    idx = slots.long().clamp(0, max(values.shape[0] - 1, 0))
    rows = _take_rows(values, idx).float().masked_fill(~inside[:, None], 0.0)
    return rows.masked_fill(~in_table[:, None], float("nan"))


def gather_dequant_groups_ref(vals, dscales, slots_cat, scin_cat, meta, slot_bounds,
                              scin_bounds) -> "list[Optional[torch.Tensor]]":
    """Plain version of :func:`gather_dequant_groups`: group by group,
    :func:`gather_dequant_ref` for a gather group; for a one-hot group
    member by member the rows of its slots, zero outside the member, as the
    JAX package's ``onehot_member_rows``, then times the per-key scales."""
    outs = []
    for v, ds, m, (a, b), sb in zip(vals, dscales, meta, slot_bounds, scin_bounds):
        if m[0] == "skip":
            outs.append(None)
            continue
        sl = slots_cat[a:b]
        si = None if sb is None else scin_cat[sb[0]:sb[1]]
        if m[0] != "onehot":
            outs.append(gather_dequant_ref(v, ds, sl, si))
            continue
        _check_onehot(v)
        _, offs, sizes, counts = m
        _check_members("gather_dequant_groups", v, offs, sizes)
        parts, p = [], 0
        for o, sz, c in zip(offs, sizes, counts):
            parts.append(_member_rows_ref(v, o, o + sz, sl[p:p + c]))
            p += c
        rows = torch.cat(parts) if parts else torch.zeros((0, v.shape[1]), dtype=torch.float32)
        outs.append(rows if si is None else rows * si[:, None])
    return outs


def _check_members(name: str, values: torch.Tensor, offs, sizes) -> None:
    if any(not 0 <= o <= o + sz <= values.shape[0] for o, sz in zip(offs, sizes)):
        raise ValueError(f"{name}: one-hot members {tuple(zip(offs, sizes))} must lie "
                         f"inside the table's {values.shape[0]} rows")


def _check_onehot(values: torch.Tensor) -> None:
    if values.dtype == torch.uint8:
        raise TypeError(
            "one-hot lookup cannot consume nibble-packed int4 arenas; use "
            "the gather path (lookup_kind='arena'/'solo')"
        )


def gather_dequant_groups(vals: Sequence[torch.Tensor],
                          dscales: Sequence[Optional[torch.Tensor]],
                          slots_cat: torch.Tensor, scin_cat: Optional[torch.Tensor],
                          meta: tuple, slot_bounds: tuple,
                          scin_bounds: tuple) -> "list[Optional[torch.Tensor]]":
    """K1 over every group of a lookup in one launch. One entry per group in
    ``vals`` (its table), ``dscales`` (device scales or None), ``meta``
    (``("gather",)``, ``("onehot", offsets, sizes, counts)`` or ``("skip",)``),
    ``slot_bounds`` (its slots ``slots_cat[a:b]``) and ``scin_bounds`` (its
    per-key scales ``scin_cat[a:b]``, or None): the packed arguments
    ``cache/lookup_program.upload_host_args`` uploads. A one-hot group's
    slots are its members' in turn (``counts`` each); a slot outside its
    member's ``[offset, offset + size)`` gives a zero row, and a one-hot
    group ignores device scales, as in the JAX package.

    -> per group its [n, D] f32 rows (None for "skip"), views of one
    buffer; the kernel launches once. Forward-only, as :func:`gather_dequant`."""
    name = "gather_dequant_groups"
    kernels.forward_only(name, *vals, *dscales, scin_cat)
    if slots_cat.device.type == "cpu":
        if any(v.device.type != "cpu" for v in vals):
            raise ValueError(f"{name}: slots on the CPU, tables on {vals[0].device}")
        return gather_dequant_groups_ref(vals, dscales, slots_cat, scin_cat, meta,
                                         slot_bounds, scin_bounds)
    dev = slots_cat.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    _check_slots(name, slots_cat, dev)
    if scin_cat is not None:
        _check_f32(name, "scin_cat", scin_cat, scin_cat.shape[0], dev)
    specs, layout, off = [], [], 0
    scin_base = scin_cat.data_ptr() if scin_cat is not None else 0
    for v, ds, m, (a, b), sb in zip(vals, dscales, meta, slot_bounds, scin_bounds):
        if m[0] == "skip":
            layout.append(None)
            continue
        _check_values(name, v, dev)
        n, d = b - a, _out_dim(v)
        if not 0 <= a <= b <= slots_cat.shape[0]:
            raise ValueError(f"{name}: slot bounds {(a, b)} outside [0, {slots_cat.shape[0]}]")
        if sb is not None and (scin_cat is None or sb[1] - sb[0] != n
                               or not 0 <= sb[0] <= sb[1] <= scin_cat.shape[0]):
            raise ValueError(f"{name}: per-key scale bounds {sb} do not match {n} slots")
        si = scin_base + 4 * sb[0] if sb is not None else 0
        layout.append((off, n, d))
        if m[0] == "onehot":
            _check_onehot(v)
            _, offs, sizes, counts = m
            if sum(counts) != n:
                raise ValueError(f"{name}: one-hot member counts {counts} do not sum to {n}")
            _check_members(name, v, offs, sizes)
            p = 0
            for o, sz, c in zip(offs, sizes, counts):
                if c:
                    specs.append(_Spec(v, 0, si and si + 4 * p, o, o + sz, a + p, c,
                                       off + p * d))
                p += c
        else:
            _check_scales(ds, si or None)
            _check_f32(name, "device scales", ds, v.shape[0], dev)
            if n:
                specs.append(_Spec(v, ds.data_ptr() if ds is not None else 0, si, 0,
                                   v.shape[0], a, n, off))
        off += -(-n * d // 4) * 4  # each group's rows start 16-byte aligned
    out = torch.empty(off, dtype=torch.float32, device=dev)
    _launch(slots_cat, out, specs)
    return [None if lay is None else out[lay[0]:lay[0] + lay[1] * lay[2]].view(lay[1], lay[2])
            for lay in layout]
