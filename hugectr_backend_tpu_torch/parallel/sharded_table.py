"""Row-sharded embedding tables and their lookups.

Port of the JAX package's parallel/sharded_table.py. A table's rows are
spread over the mesh's shard axis, INTERLEAVED (the reference's key-low-bits
partitioning): slot ``s`` lives on shard ``s % P`` at local row ``s // P``,
so the unique slots of any batch spread near-uniformly over the shards.
Shard ``k``'s block is its own tensor on ``mesh.shard_devices()[k]``.

Two lookup strategies, as in the JAX package (both return [N, D] f32 on the
mesh's output device):

- ``all_to_all`` (the serving default): the host dedups the batch and
  routes each unique slot to its owner's bucket (:func:`plan_all_to_all`);
  each shard gathers its own bucket, the blocks are concatenated in shard
  order (the JAX package's ``all_gather``) and ``expand`` restores request
  order, duplicates included.
- ``psum``: each shard gathers the full slot vector, the rows it does not
  own are masked to 0 and the partials are summed in f32 (so a stored -0.0
  comes out +0.0, as the JAX package's psum gives it; all_to_all keeps it).
  A slot outside ``[0, rows_padded)`` gives a zero row.

Every gather is K1 (``ops/dequant_gather.gather_dequant_groups``): ONE
launch per device per lookup, over every (table, shard) group that device
holds; the JAX package computes these gathers with ``jnp.take`` inside
``shard_map``. The mask, the sum, the concatenation and the expand are plain
tensor ops (XLA's in the JAX package). K1 is forward-only, so the gather of
a shard that requires a gradient goes through :class:`_GatherGroups`, whose
backward is an ``index_add_`` of ``grad * scale`` into the shard's rows (the
JAX package's ``take`` VJP, a scatter-add).

On a mesh over a process group (parallel/mesh.py) each rank gathers its
own shards; all_to_all becomes ``all_gather_into_tensor`` of the ranks'
blocks and psum an ``all_reduce`` of their partial sums. Every rank computes
the same replicated result (and, in training, the same loss), so the
backward of the all_reduce is the identity and that of the all_gather
takes this rank's slice.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from hugectr_backend_tpu_torch.cache import lookup_program
from hugectr_backend_tpu_torch.cache.embedding_cache import _bucket as _bucket_pow2
from hugectr_backend_tpu_torch.ops.dequant_gather import gather_dequant_groups
from hugectr_backend_tpu_torch.ops.quantize import quantize_rows_int4, quantize_rows_int8
from hugectr_backend_tpu_torch.parallel.mesh import Mesh
from hugectr_backend_tpu_torch.tiers.hbm import KeyIndex, dedup_int64

STRATEGIES = ("psum", "all_to_all")


@dataclasses.dataclass
class ShardedTable:
    """One embedding table row-sharded over the mesh's shard axis.

    ``values[j]`` / ``scales[j]`` hold this rank's ``j``-th shard: global
    shard ``shard_ids[j]``, the ``rows_padded // P`` interleaved rows
    ``{s : s % P == shard_ids[j]}`` stored contiguously. Slot semantics are
    DeviceTable's: ``index`` maps keys to global slots, and a miss maps to
    ``miss_slot`` = the table's row count, the first padding row (all
    ``default_value``), which lives on shard ``n % P``."""

    values: list  # per local shard [shard_rows, W] on its device
    scales: Optional[list]  # per local shard [shard_rows] f32, or None
    index: KeyIndex
    mesh: Mesh
    dim: int
    quant: str
    rows_padded: int

    @classmethod
    def from_numpy(cls, keys: np.ndarray, vectors: np.ndarray, mesh: Mesh,
                   quant: str = "int8", default_value: float = 0.0) -> "ShardedTable":
        vectors = np.asarray(vectors, dtype=np.float32)
        index, order = KeyIndex.build(keys)
        vectors = vectors[order]
        n, dim = vectors.shape
        n_shards = mesh.shape[mesh.shard_axis]
        # Pad so that (rows + 1 default row) divides evenly over shards.
        r_pad = -((n + 1) // -n_shards) * n_shards
        pad_rows = r_pad - n
        scales = None
        if quant == "int8":
            q, s = quantize_rows_int8(vectors)
            vals = torch.from_numpy(np.concatenate([q, np.zeros((pad_rows, dim), np.int8)]))
            scales = np.concatenate([s, np.ones(pad_rows, np.float32)])
        elif quant == "int4":
            # Nibble-packed rows ([R, D/2] uint8): 2x int8's rows per shard
            # byte; K1 unpacks them.
            q, s = quantize_rows_int4(vectors)
            vals = torch.from_numpy(
                np.concatenate([q, np.zeros((pad_rows, dim // 2), np.uint8)]))
            scales = np.concatenate([s, np.ones(pad_rows, np.float32)])
        elif quant in ("fp32", "bf16"):
            vals = torch.from_numpy(np.concatenate(
                [vectors, np.full((pad_rows, dim), default_value, np.float32)]))
            if quant == "bf16":
                vals = vals.to(torch.bfloat16)
        else:
            raise ValueError(f"unsupported quant {quant!r} for sharded tables")
        if quant in ("int8", "int4") and default_value != 0.0:
            raise NotImplementedError(
                f"sharded {quant} tables currently support default_value 0.0"
            )
        # Interleaved placement: shard k holds slots k, k + P, k + 2P, ...
        shard_ids = _local_shard_ids(mesh)
        devices = mesh.shard_devices()
        values = [vals[k::n_shards].contiguous().to(dev) for k, dev in zip(shard_ids, devices)]
        scales_t = None
        if scales is not None:
            st = torch.from_numpy(np.ascontiguousarray(scales, np.float32))
            scales_t = [st[k::n_shards].contiguous().to(dev)
                        for k, dev in zip(shard_ids, devices)]
        table = cls(values=values, scales=scales_t, index=index, mesh=mesh, dim=dim,
                    quant=quant, rows_padded=r_pad)
        # Misses land on the first padding row (all default_value).
        table.index.miss_slot = n
        return table

    def slots_for(self, keys: np.ndarray) -> np.ndarray:
        return self.index.lookup(keys)

    @property
    def capacity(self) -> int:
        """Resident-row count (DeviceTable-compatible; the serving batcher
        keys its pow2 bucket grid off this)."""
        return self.index.capacity

    @property
    def shard_axis(self) -> str:
        return self.mesh.shard_axis

    @property
    def n_shards(self) -> int:
        return self.mesh.shape[self.shard_axis]

    @property
    def shard_rows(self) -> int:
        return self.rows_padded // self.n_shards

    @property
    def shard_ids(self) -> list:
        return _local_shard_ids(self.mesh)

    def nbytes_per_shard(self) -> int:
        """Bytes of one shard: its rows (D/2 bytes a row for int4) and its
        scales."""
        row = self.values[0].shape[1] * self.values[0].element_size()
        return int(self.rows_padded * (row + (4 if self.scales is not None else 0))
                   // self.n_shards)


def _local_shard_ids(mesh: Mesh) -> list:
    local = mesh.local_shards
    return list(range(mesh.rank * local, mesh.rank * local + local))


# ------------------------------------------------------------------ routing


def plan_all_to_all(slots: np.ndarray, n_shards: int, shard_rows: int,
                    min_capacity: int = 8) -> "tuple[np.ndarray, np.ndarray]":
    """Host-side routing plan for the all_to_all strategy.

    Dedups ``slots`` and buckets each unique slot to its owner shard (owner =
    slot % n_shards; local row = slot // n_shards).

    -> (buckets [n_shards, cap] int32 LOCAL row indices, zero-padded;
        expand [N] int32 indices into the flattened [n_shards * cap] gathered
        rows, restoring request order, duplicates included).

    ``cap`` is the pow2 bucket of the largest per-owner unique count: exact
    for this batch, so nothing overflows. The unique slots come from the
    native dedup in first-seen order, so a bucket's order differs from the
    JAX package's (``np.unique``'s sorted order where its library is not
    built); the rows a bucket names and what ``expand`` resolves to do not.
    """
    slots = np.asarray(slots, dtype=np.int64).reshape(-1)
    if slots.size and (
        int(slots.max()) >= n_shards * shard_rows or int(slots.min()) < 0
    ):
        # An out-of-range slot would gather a wrong row (K1 writes NaN past
        # the shard, the psum strategy masks it to zeros): refuse it here so
        # that the two strategies cannot silently disagree.
        raise ValueError(
            f"slot out of range [0, {n_shards * shard_rows}) in "
            "all_to_all routing plan"
        )
    uniq, inv = dedup_int64(slots)
    owner = uniq % n_shards
    counts = np.bincount(owner, minlength=n_shards)
    cap = _bucket_pow2(max(int(counts.max()), 1), min_capacity)
    order = np.argsort(owner, kind="stable")
    start = np.concatenate([[0], np.cumsum(counts)])
    within = np.empty(uniq.shape[0], np.int64)
    within[order] = np.arange(uniq.shape[0]) - start[owner[order]]
    buckets = np.zeros((n_shards, cap), np.int32)
    buckets[owner, within] = (uniq // n_shards).astype(np.int32)
    expand = (owner * cap + within)[inv].astype(np.int32)
    return buckets, expand


def plan_psum(slots: np.ndarray, n_shards: int, shard_rows: int,
              shard_ids: Sequence[int]) -> "tuple[np.ndarray, np.ndarray]":
    """The psum strategy's per-shard gathers: -> (local [L, N] int32, mine
    [L, N] bool) for the shards ``shard_ids``: shard k gathers local row
    ``slot // P`` where it owns the slot and row 0 elsewhere (masked)."""
    slots = np.asarray(slots, dtype=np.int64).reshape(-1)
    local = slots // n_shards
    ids = np.asarray(shard_ids, np.int64)[:, None]
    mine = ((slots % n_shards)[None, :] == ids) & ((slots >= 0) & (local < shard_rows))[None, :]
    return np.where(mine, local[None, :], 0).astype(np.int32), mine


class Routed(NamedTuple):
    """One table's routing for one lookup: psum (``local``, ``mine``) or
    all_to_all (``buckets``, ``expand``); the other two are None."""

    local: Optional[np.ndarray] = None
    mine: Optional[np.ndarray] = None
    buckets: Optional[np.ndarray] = None
    expand: Optional[np.ndarray] = None


def route(table: ShardedTable, slots: np.ndarray, strategy: str) -> Routed:
    """Plan one table's lookup of ``slots`` under ``strategy``."""
    if strategy == "all_to_all":
        buckets, expand = plan_all_to_all(slots, table.n_shards, table.shard_rows)
        return Routed(buckets=buckets, expand=expand)
    if strategy != "psum":
        raise ValueError(f"unknown sharded lookup strategy {strategy!r}")
    local, mine = plan_psum(slots, table.n_shards, table.shard_rows, table.shard_ids)
    return Routed(local=local, mine=mine)


# ------------------------------------------------------------------ gathers


class _GatherGroups(torch.autograd.Function):
    """K1 over the groups of one device (one launch) with a backward: the
    gradient of group g's rows, times their scales, is added into the rows
    its slots name (``index_add_``). Used only when a table's values require
    a gradient (f32 tables in training)."""

    @staticmethod
    def forward(ctx, plan, slots_cat, *vals):
        dscales, meta, sb, cb = plan
        ctx.plan = plan
        ctx.save_for_backward(slots_cat, *vals)
        outs = gather_dequant_groups(list(vals), dscales, slots_cat, None, meta, sb, cb)
        # The card's rows are views of one buffer: hand autograd tensors of
        # their own.
        return tuple(o if o._base is None else o.clone() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        dscales, _, sb, _ = ctx.plan
        slots_cat, *vals = ctx.saved_tensors
        gv = [None] * len(vals)
        for g, (v, ds, (a, b), go) in enumerate(zip(vals, dscales, sb, grads)):
            if not ctx.needs_input_grad[2 + g] or go is None:
                continue
            idx = slots_cat[a:b].long()
            if ds is not None:
                go = go * ds.index_select(0, idx)[:, None]
            gv[g] = torch.zeros(v.shape, dtype=go.dtype, device=v.device).index_add_(
                0, idx, go).to(v.dtype)
        return (None, None, *gv)


def gather_shards(groups: "list[tuple[torch.Tensor, Optional[torch.Tensor], np.ndarray]]"
                  ) -> list:
    """Gather + dequantize ``(values, scales, local_rows)`` groups: ONE K1
    launch per device over every group that device holds. -> per group its
    [n, D] f32 rows on the group's device."""
    by_dev: dict = {}
    for i, (v, _, _) in enumerate(groups):
        by_dev.setdefault(v.device, []).append(i)
    out: list = [None] * len(groups)
    for dev, idx in by_dev.items():
        vals = [groups[i][0] for i in idx]
        dscales = [groups[i][1] for i in idx]
        slots_l = [np.asarray(groups[i][2], np.int32).reshape(-1) for i in idx]
        slots_cat, sb, _, cb = lookup_program.upload_host_args(
            vals, slots_l, [None] * len(idx), dev)
        meta = (("gather",),) * len(idx)
        if torch.is_grad_enabled() and any(v.requires_grad for v in vals):
            rows = _GatherGroups.apply((dscales, meta, sb, cb), slots_cat, *vals)
        else:
            rows = gather_dequant_groups(vals, dscales, slots_cat, None, meta, sb, cb)
        for i, r in zip(idx, rows):
            out[i] = r
    return out


class _AllReduceSum(torch.autograd.Function):
    """psum over the mesh's ranks; the backward is the identity (every rank
    holds the same replicated result and loss)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        torch.distributed.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    """The ranks' blocks concatenated in rank order; the backward takes this
    rank's slice (every rank holds the same replicated result and loss)."""

    @staticmethod
    def forward(ctx, x, group):
        world = torch.distributed.get_world_size(group)
        ctx.rank, ctx.rows = torch.distributed.get_rank(group), x.shape[0]
        out = x.new_empty((world * x.shape[0], *x.shape[1:]))
        torch.distributed.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def _concat_blocks(blocks: list) -> torch.Tensor:
    """The shards' row blocks as one [sum, D] tensor. K1's grouped output is
    one buffer with each group starting 16-byte aligned; when the blocks lie
    back to back in it (a bucket's rows times D is a multiple of 4 floats,
    always so with cap >= 8) it is used as is, otherwise they are copied."""
    base = blocks[0]._base
    if (base is not None and not any(b.requires_grad for b in blocks)
            and all(b._base is base and b.is_contiguous() for b in blocks)):
        start = blocks[0].data_ptr()
        pos, ok = start, True
        for b in blocks:
            ok &= b.data_ptr() == pos
            pos += b.numel() * b.element_size()
        if ok:
            off = (start - base.data_ptr()) // base.element_size()
            n = sum(b.shape[0] for b in blocks)
            return base[off:off + n * blocks[0].shape[1]].view(n, blocks[0].shape[1])
    return torch.cat(blocks)


def lookup_tables(tables: Sequence[ShardedTable], routed: Sequence[Routed],
                  strategy: str) -> list:
    """Every table's sharded lookup: one K1 launch per device over all
    tables' shards, then each strategy's combine on the output device.
    -> per table [N_t, D_t] f32."""
    groups, spans = [], []
    for t, r in zip(tables, routed):
        g0 = len(groups)
        for j, k in enumerate(t.shard_ids):
            rows = r.local[j] if strategy == "psum" else r.buckets[k]
            groups.append((t.values[j], None if t.scales is None else t.scales[j], rows))
        spans.append((g0, len(groups)))
    rows = gather_shards(groups)
    combine = _upload_by_device(
        [r.mine if strategy == "psum" else r.expand.astype(np.int64) for r in routed],
        [t.mesh.out_device for t in tables])
    outs = []
    for t, (g0, g1), aux in zip(tables, spans, combine):
        out_dev = t.mesh.out_device
        blocks = [x.to(out_dev) for x in rows[g0:g1]]
        group = t.mesh.group
        if strategy == "psum":
            mine = aux
            acc = None
            for j, blk in enumerate(blocks):
                part = torch.where(mine[j][:, None], blk, 0.0)
                acc = part if acc is None else acc + part
            if group is not None:
                acc = _AllReduceSum.apply(acc, group)
            outs.append(acc)
            continue
        allr = _concat_blocks(blocks)
        if group is not None:
            allr = _AllGather.apply(allr, group)
        outs.append(allr.index_select(0, aux))
    return outs


def _upload_by_device(arrays: list, devices: list) -> list:
    """Each host array on its device, in one copy per device (the combine's
    masks or expands of every table of a lookup)."""
    out: list = [None] * len(arrays)
    for dev in dict.fromkeys(devices):
        idx = [i for i, d in enumerate(devices) if d == dev]
        flat = torch.from_numpy(np.concatenate([arrays[i].reshape(-1) for i in idx])).to(dev)
        off = 0
        for i in idx:
            out[i] = flat[off:off + arrays[i].size].view(arrays[i].shape)
            off += arrays[i].size
    return out


def sharded_lookup(table: ShardedTable, slots, strategy: str = "psum") -> torch.Tensor:
    """[N, D] float32 lookup across the mesh, on its output device.

    ``strategy``: "psum" (the default, as in the JAX package) or
    "all_to_all" (host dedup + bucket routing). ``slots`` are host slots (a
    tensor is copied to the host: the routing is planned there)."""
    if isinstance(slots, torch.Tensor):
        slots = slots.detach().cpu().numpy()
    (out,) = lookup_tables([table], [route(table, slots, strategy)], strategy)
    return out
