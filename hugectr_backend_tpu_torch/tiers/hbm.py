"""Device-resident embedding tables: the device tier.

Port of the JAX package's tiers/hbm.py. Tables live on the card row-quantized
(INT8 / FP8-e4m3 / INT4 / BF16 / FP32). A host-side :class:`KeyIndex` maps
query keys to dense row slots; misses map to a *default row* appended at slot
``capacity``, so the device gather needs no masking.

Tables are stored flat ``[R, D]``. The JAX package stores tables of more than
``HPS_TPU_MAX_GATHER_ROWS`` rows blocked as ``[K, SUB, D]`` for the TPU
compiler's sake; the layout changes no result, so it is not carried over.

Host arrays are numpy, except the quantized values of a table, which are a
CPU ``torch.Tensor`` until they move to the device: numpy has no bf16 or fp8.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from hugectr_backend_tpu_torch.ops.quantize import (
    FP8_E4M3_MAX,
    INT4_QMAX,
    INT8_QMAX,
    pack_int4,
    quantize_rows_fp8,
    quantize_rows_int4,
    quantize_rows_int8,
)

Quant = str  # "fp32" | "bf16" | "int8" | "fp8" | "int4"


def default_device(device=None) -> torch.device:
    """The device an entry point puts its tensors on: the card (``cuda:0``
    unless ``device`` names another) unless the caller asks for the CPU
    (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run on the "
            "CPU with the kernels' plain PyTorch versions"
        )
    return dev if dev.index is not None else torch.device("cuda", 0)


#: Past this many rows a table's index searches its sorted keys instead of
#: building the native hash (~16 B of host RAM per bucket at load <= 0.75,
#: pow2-rounded): the JAX package's cap (its HPS_TPU_NATIVE_INDEX_MAX_ROWS
#: default).
NATIVE_INDEX_MAX_ROWS = 64_000_000


class _NativeStaticIndex:
    """ctypes view over ``native/kvstore.cpp``'s StaticMap (an immutable
    key -> slot hash). Bit-identical to the searchsorted lookup (slot i ==
    position in the sorted key array); bulk ``translate`` is read-only,
    lock-free, and runs on the native persistent pool for large key runs."""

    def __init__(self, lib, handle, miss_slot: int):
        self.lib = lib
        self.handle = handle
        self.miss_slot = int(miss_slot)

    def translate(self, keys: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, np.int64).reshape(-1)
        out = np.empty(keys.shape[0], np.int32)
        self.lib.hps_statmap_translate(
            self.handle, keys.shape[0],
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.miss_slot,
        )
        return out

    def __del__(self):
        self.lib.hps_statmap_destroy(self.handle)


def _make_native_statmap(sorted_keys: np.ndarray) -> _NativeStaticIndex:
    """Build the native static index over ``sorted_keys`` (slot i is key i).
    Raises when the native library does not build."""
    from hugectr_backend_tpu_torch.native.kvstore import load_lib

    lib = load_lib()
    keys = np.ascontiguousarray(sorted_keys, np.int64)
    handle = lib.hps_statmap_create(
        keys.shape[0], keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if not handle:
        raise MemoryError(f"hps_statmap_create failed for {keys.shape[0]} keys")
    return _NativeStaticIndex(lib, handle, miss_slot=keys.shape[0])


def dedup_int64(values: np.ndarray):
    """Dedup an int64 array: -> (uniq, inv) with ``uniq[inv] == values``, in
    one O(n) native pass (``native/kvstore.cpp hps_dedup_i64``; the all-to-all
    plan of parallel/sharded_table.py). NOTE: ``uniq`` is in first-seen
    order, not sorted as ``np.unique``'s: callers must not rely on it."""
    from hugectr_backend_tpu_torch.native.kvstore import load_lib

    values = np.ascontiguousarray(values, np.int64).reshape(-1)
    n = values.shape[0]
    if n == 0:
        return values, np.empty(0, np.int64)
    uniq = np.empty(n, np.int64)
    inv = np.empty(n, np.int32)
    r = load_lib().hps_dedup_i64(
        n, values.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        uniq.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        inv.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return uniq[:r], inv.astype(np.int64)


def translate_indexes_batch(indexes, keys_list) -> list:
    """Translate many ``(KeyIndex, keys)`` pairs; ONE native call covers all
    native-backed indexes, so every table's chunks run in parallel on the
    native pool (a request's host translation is then bounded by its largest
    chunk, not the sum over tables). Direct, searched and empty entries take
    ``KeyIndex.lookup``. -> list of int32 slot arrays, bit-identical to
    per-table ``lookup`` calls."""
    out: list = [None] * len(indexes)
    nat, keys_c = [], []
    for i, idx in enumerate(indexes):
        k = np.ascontiguousarray(keys_list[i], np.int64).reshape(-1)
        keys_c.append(k)
        if idx._native is not None and k.shape[0] > 0:
            nat.append(i)
        else:
            out[i] = idx.lookup(k)
    if len(nat) == 1:
        out[nat[0]] = indexes[nat[0]]._native.translate(keys_c[nat[0]])
    elif nat:
        from hugectr_backend_tpu_torch.native.kvstore import batch_translate_args

        outs, args, keepalive = batch_translate_args(
            [indexes[i]._native.handle for i in nat],
            [keys_c[i] for i in nat],
            [indexes[i]._native.miss_slot for i in nat],
        )
        indexes[nat[0]]._native.lib.hps_statmap_translate_batch(*args)
        del keepalive
        for j, i in enumerate(nat):
            out[i] = outs[j]
    return out


class KeyIndex:
    """Host-side key -> slot map over a sorted key array.

    Misses return ``miss_slot`` (== capacity, the default row). Three access
    paths, all bit-identical, as in the JAX package:

    - "direct": keys are already dense ``0..N-1``; lookup is a bounds check.
    - the native StaticMap (``native/kvstore.cpp``): an immutable
      open-addressing hash probed lock-free and in parallel, ~1.3 cache
      misses per key against ~log2(N) for a binary search. Every other table
      of 1 to ``NATIVE_INDEX_MAX_ROWS`` rows takes it.
    - ``np.searchsorted`` over the sorted keys past ``NATIVE_INDEX_MAX_ROWS``
      rows (and for an empty table). ``search`` is this path for any table:
      the plain version that tests hold the native index against.
    """

    def __init__(self, sorted_keys: np.ndarray, direct: bool):
        self.sorted_keys = sorted_keys
        self.direct = direct
        self.capacity = int(sorted_keys.shape[0])
        self.miss_slot = self.capacity
        self._native = None
        if not direct and 1 <= self.capacity <= NATIVE_INDEX_MAX_ROWS:
            self._native = _make_native_statmap(sorted_keys)

    @classmethod
    def build(cls, keys: np.ndarray):
        """-> (index, row_order) where row_order re-orders table rows to match."""
        keys = np.asarray(keys, dtype=np.int64)
        order = np.argsort(keys, kind="stable")
        sorted_keys = keys[order]
        if sorted_keys.size > 1 and np.any(sorted_keys[1:] == sorted_keys[:-1]):
            raise ValueError("duplicate keys in embedding table")
        n = sorted_keys.shape[0]
        direct = bool(n > 0 and sorted_keys[0] == 0 and sorted_keys[-1] == n - 1)
        return cls(sorted_keys, direct), order

    def lookup(self, query_keys: np.ndarray) -> np.ndarray:
        """-> int32 slots; missing keys -> self.miss_slot."""
        q = np.asarray(query_keys, dtype=np.int64)
        if self.direct:
            miss = (q < 0) | (q >= self.capacity)
            return np.where(miss, self.miss_slot, q).astype(np.int32)
        if self._native is not None:
            return self._native.translate(q).reshape(q.shape)
        return self.search(q)

    def search(self, query_keys: np.ndarray) -> np.ndarray:
        """The searchsorted lookup (any non-direct table): the native
        index's plain version. -> int32 slots; misses -> self.miss_slot."""
        q = np.asarray(query_keys, dtype=np.int64)
        if self.capacity == 0:
            return np.full(q.shape, self.miss_slot, dtype=np.int32)
        pos = np.searchsorted(self.sorted_keys, q)
        pos_c = np.minimum(pos, self.capacity - 1)
        hit = self.sorted_keys[pos_c] == q
        return np.where(hit, pos_c, self.miss_slot).astype(np.int32)


def _default_row_quant(dim: int, default_value: float, qmax: float):
    """Quantized representation of the all-``default_value`` miss row."""
    if default_value == 0.0:
        return np.zeros(dim, dtype=np.float32), np.float32(1.0)
    scale = abs(default_value) / qmax
    q = np.full(dim, np.sign(default_value) * qmax, dtype=np.float32)
    return q, np.float32(scale)


def quantize_host_rows(vectors_sorted: np.ndarray, quant: Quant,
                       default_value: float,
                       order: "np.ndarray | None" = None):
    """Quantize sorted rows + append the default (miss) row.
    -> (vals CPU tensor [n+1, W], scales numpy [n+1] or None); W = dim, or
    dim // 2 for int4.

    ``order`` (optional): output row i comes from source row ``order[i]``;
    the int8/int4 native quantizer folds this gather into its single pass."""
    dim = int(vectors_sorted.shape[1])
    if quant not in ("int8", "int4") and order is not None:
        vectors_sorted = np.asarray(vectors_sorted, np.float32)[order]
        order = None
    if quant == "int8":
        q, s = quantize_rows_int8(vectors_sorted, order=order)
        dq, ds = _default_row_quant(dim, default_value, INT8_QMAX)
        vals = np.concatenate([q, np.clip(dq, -127, 127)[None].astype(np.int8)])
        return torch.from_numpy(vals), np.concatenate([s, ds[None]])
    if quant == "fp8":
        q, s = quantize_rows_fp8(vectors_sorted)
        dq, ds = _default_row_quant(dim, default_value, FP8_E4M3_MAX)
        drow = torch.from_numpy(dq[None]).to(torch.float8_e4m3fn)
        return torch.cat([q, drow]), np.concatenate([s, ds[None]])
    if quant == "int4":
        if dim % 2:
            raise ValueError("int4 tables require an even embedding dim")
        q, s = quantize_rows_int4(vectors_sorted, order=order)
        dq, ds = _default_row_quant(dim, default_value, INT4_QMAX)
        dpack = pack_int4(np.clip(dq, -7, 7).astype(np.int8)[None])
        return torch.from_numpy(np.concatenate([q, dpack])), np.concatenate([s, ds[None]])
    if quant in ("fp32", "bf16"):
        drow = np.full((1, dim), default_value, dtype=np.float32)
        vals = torch.from_numpy(
            np.concatenate([np.asarray(vectors_sorted, np.float32), drow]))
        return (vals if quant == "fp32" else vals.to(torch.bfloat16)), None
    raise ValueError(f"unknown quant mode {quant!r}")


def _pad_rows(vals: torch.Tensor, scales, n: int):
    """Append ``n`` copies of the LAST row (the default/miss row) and its
    scale: the one-hot arena's 128-row member alignment. Pad rows are never
    addressable (slots are always <= capacity == the default row)."""
    if n <= 0:
        return vals, scales
    vals = torch.cat([vals, vals[-1:].expand(n, -1)])
    if scales is not None:
        scales = np.concatenate([scales, np.repeat(scales[-1:], n)])
    return vals, scales


def _put(vals: torch.Tensor, scales, device):
    return (vals.contiguous().to(device),
            None if scales is None else torch.from_numpy(
                np.ascontiguousarray(scales, np.float32)).to(device))


@dataclasses.dataclass
class DeviceTable:
    """One embedding table resident on the device.

    ``values`` has ``capacity + 1`` rows; row ``capacity`` is the default row
    returned for missing keys."""

    values: torch.Tensor  # [capacity+1, W] in the quant dtype
    scales: Optional[torch.Tensor]  # [capacity+1] f32 (None for fp32/bf16)
    index: KeyIndex
    dim: int
    quant: Quant
    default_value: float

    @property
    def capacity(self) -> int:
        return self.index.capacity

    @classmethod
    def from_numpy(cls, keys: np.ndarray, vectors: np.ndarray,
                   quant: Quant = "int8", default_value: float = 0.0,
                   device=None) -> "DeviceTable":
        device = default_device(device)
        vectors = np.asarray(vectors, dtype=np.float32)
        index, order = KeyIndex.build(keys)
        vals, scales = quantize_host_rows(vectors, quant, default_value, order=order)
        vals, scales = _put(vals, scales, device)
        return cls(values=vals, scales=scales, index=index,
                   dim=int(vectors.shape[1]), quant=quant,
                   default_value=default_value)

    def slots_for(self, keys: np.ndarray) -> np.ndarray:
        return self.index.lookup(keys)

    def nbytes(self) -> int:
        n = self.values.numel() * self.values.element_size()
        if self.scales is not None:
            n += self.scales.numel() * 4
        return int(n)


@dataclasses.dataclass
class DeviceArena:
    """One device allocation holding MANY logical tables of the same
    dim/quant, concatenated row-wise, so a multi-table lookup is one gather
    over arena-global slots (= local slot + table offset). Each member keeps
    its own default row.

    ``lookup_kind`` ("arena" | "solo" | "onehot") is the grouping policy of
    the parameter server. On the card all three are served by K1; "solo" and
    "onehot" gather their scales on the host during translation
    (``scales_host``), and the fused DLRM server folds a "onehot" group into
    the interaction kernel (K3)."""

    values: torch.Tensor  # [R_total, W]
    scales: Optional[torch.Tensor]
    dim: int
    quant: Quant
    total_rows: int  # physical rows incl. per-table default and pad rows
    scales_host: Optional[np.ndarray] = None
    lookup_kind: str = "arena"


@dataclasses.dataclass
class ArenaView:
    """DeviceTable-compatible view of one member table inside a DeviceArena.

    ``block_rows`` is the member's PHYSICAL row count inside the arena
    (>= capacity + 1): one-hot arenas pad each member to a multiple of 128
    rows, as in the JAX package. Pad rows replicate the default row and are
    never selected."""

    arena: DeviceArena
    index: KeyIndex
    offset: int
    dim: int
    quant: Quant
    default_value: float
    block_rows: int = 0  # physical rows; 0 -> capacity + 1

    @property
    def capacity(self) -> int:
        return self.index.capacity

    @property
    def values(self) -> torch.Tensor:
        return self.arena.values[self.offset : self.offset + self.capacity + 1]

    @property
    def scales(self):
        if self.arena.scales is None:
            return None
        return self.arena.scales[self.offset : self.offset + self.capacity + 1]

    def slots_for(self, keys: np.ndarray) -> np.ndarray:
        return self.index.lookup(keys)

    def nbytes(self) -> int:
        rows = self.block_rows or self.capacity + 1
        v = self.arena.values
        n = rows * int(v.shape[-1]) * v.element_size()
        if self.arena.scales is not None:
            n += rows * 4
        return int(n)


def build_arena_views(
    tables: "Sequence[tuple[np.ndarray, np.ndarray]]",
    quant: Quant = "int8",
    default_values: Optional[Sequence[float]] = None,
    device=None,
    lookup_kind: str = "arena",
) -> list[ArenaView]:
    """Build one shared arena from [(keys, vectors), ...] of equal dim.

    Returns per-table views; ``view.offset + local_slot`` addresses the arena.
    "solo" and "onehot" arenas keep a host copy of the scales for
    translation-time fetch."""
    if not tables:
        return []
    device = default_device(device)
    default_values = default_values or [0.0] * len(tables)
    dim = int(np.asarray(tables[0][1]).shape[1])

    def prep_member(args):
        (keys, vectors), dv = args
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.shape[1] != dim:
            raise ValueError("arena members must share the embedding dim")
        index, order = KeyIndex.build(keys)
        v, s = quantize_host_rows(vectors, quant, dv, order=order)
        return index, v, s

    if len(tables) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(len(tables), 8)) as ex:
            prepped = list(ex.map(prep_member, zip(tables, default_values)))
    else:
        prepped = [prep_member(a) for a in zip(tables, default_values)]

    vals_parts, scales_parts, views_meta = [], [], []
    offset = 0
    align = 128 if lookup_kind == "onehot" else 1
    for (index, v, s), dv in zip(prepped, default_values):
        rows = v.shape[0]
        block = -(-rows // align) * align
        v, s = _pad_rows(v, s, block - rows)
        vals_parts.append(v)
        if s is not None:
            scales_parts.append(s)
        views_meta.append((index, offset, dv, block))
        offset += block
    vals = torch.cat(vals_parts)
    scales = np.concatenate(scales_parts) if scales_parts else None
    keep_host_scales = lookup_kind in ("solo", "onehot") and scales is not None
    values_d, scales_d = _put(vals, scales, device)
    arena = DeviceArena(
        values=values_d,
        scales=scales_d,
        dim=dim,
        quant=quant,
        total_rows=int(vals.shape[0]),
        scales_host=scales.copy() if keep_host_scales else None,
        lookup_kind=lookup_kind,
    )
    return [
        ArenaView(arena=arena, index=index, offset=off, dim=dim, quant=quant,
                  default_value=dv, block_rows=block)
        for index, off, dv, block in views_meta
    ]


def scatter_rows(values: torch.Tensor, slots: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """A copy of ``values`` with ``values[slots] = rows``. As in the JAX
    package (``.at[slots].set(mode="drop")``), a slot in ``[-R, 0)`` wraps to
    ``R + slot`` (NumPy indexing) and a slot still out of range (padding) is
    dropped. Functional: readers holding ``values`` never see the write."""
    r = values.shape[0]
    slots = slots.long()
    slots = torch.where(slots < 0, slots + r, slots)
    keep = (slots >= 0) & (slots < r)
    out = values.clone()
    out[slots[keep]] = rows[keep].to(values.dtype)
    return out
