"""The shared device lookup program: one access path for every serving
surface (EmbeddingCache.lookup / lookup_flat and the fused DLRM server).

Port of the JAX package's cache/lookup_program.py. Every group of a lookup
runs in ONE launch of K1 (``gather_dequant_groups``, ops/dequant_gather.py),
as the JAX package jits them into one program:

- "gather": ``values[slots] * device_scales[slots]`` (the arena kind), or
  ``values[slots] * scin`` with host-gathered per-key scales (the solo kind);
- "onehot": the JAX package multiplies a one-hot mask into each member table
  on the TPU's matrix unit; the product is exact, so a gather of the member
  rows gives the same bits, and a slot outside its member a zero row;
- "skip": the caller consumes the group elsewhere (the fused DLRM server
  folds a one-hot group into the interaction kernel).

The functions run eagerly; capturing them per batch bucket in CUDA graphs
(``use_cuda_graph``) is ROADMAP queue A item 2.
"""

from __future__ import annotations

import numpy as np
import torch

from hugectr_backend_tpu_torch.ops.dequant_gather import gather_dequant_groups


def pack_host_args(slots_l, scin_l):
    """Pack per-group host arrays into ONE slots array + ONE scales array
    (+ bounds): two uploads instead of ~2 x n_groups. -> (slots_cat,
    slot_bounds, scin_cat, scin_bounds)."""
    bounds, off = [], 0
    for a in slots_l:
        bounds.append((off, off + a.shape[0]))
        off += a.shape[0]
    slots_cat = np.concatenate(slots_l) if slots_l else np.zeros(0, np.int32)
    sbounds, off, parts = [], 0, []
    for s in scin_l:
        if s is None:
            sbounds.append(None)
        else:
            sbounds.append((off, off + s.shape[0]))
            off += s.shape[0]
            parts.append(s)
    scin_cat = np.concatenate(parts) if parts else None
    return slots_cat, tuple(bounds), scin_cat, tuple(sbounds)


def upload_host_args(vals, slots_l, scin_l, device):
    """Check every group's slots against its table on the host, pack them
    and upload. -> (slots_cat, slot_bounds, scin_cat, scin_bounds) with the
    two arrays on ``device``. The kernels never clamp, so an out-of-range
    slot is refused here, before it reaches the card."""
    for g, (v, s) in enumerate(zip(vals, slots_l)):
        if s.size and (int(s.min()) < 0 or int(s.max()) >= v.shape[0]):
            raise ValueError(
                f"group {g}: slots outside [0, {v.shape[0]}) "
                f"(min {int(s.min())}, max {int(s.max())})"
            )
    slots_cat, sb, scin_cat, cb = pack_host_args(slots_l, scin_l)
    slots_d = torch.from_numpy(np.ascontiguousarray(slots_cat, np.int32)).to(device)
    scin_d = (None if scin_cat is None else torch.from_numpy(
        np.ascontiguousarray(scin_cat, np.float32)).to(device))
    return slots_d, sb, scin_d, cb


def lookup_groups(vals, dscales, slots_cat, scin_cat, meta, slot_bounds,
                  scin_bounds):
    """Group lookups over packed device inputs -> per-group f32 rows, in one
    K1 launch."""
    return gather_dequant_groups(vals, dscales, slots_cat, scin_cat, meta, slot_bounds,
                                 scin_bounds)


def lookup_flat(vals, dscales, slots_cat, scin_cat, meta, slot_bounds,
                scin_bounds, slices):
    """Group lookups + per-table slice + flatten into one f32 vector
    (table-major, the OUTPUT0 wire layout). ``slices[t]`` is the (group,
    start, count) of table t's rows."""
    gouts = lookup_groups(vals, dscales, slots_cat, scin_cat, meta,
                          slot_bounds, scin_bounds)
    parts = [gouts[g][start : start + count].reshape(-1)
             for (g, start, count) in slices]
    if not parts:
        return torch.zeros((0,), dtype=torch.float32, device=slots_cat.device)
    return torch.cat(parts)
