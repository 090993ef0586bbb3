"""xDeepFM dense network: Compressed Interaction Network (CIN) + deep MLP.

Port of the JAX package's models/xdeepfm.py. A CIN layer::

    x^0 = emb                                   [B, T, D]
    z^k = x^{k-1} (outer) x^0 over features     [B, H * T, D]
    x^k = W^k z^k  ("bkd,gk->bgd")              [B, G, D]

is one batched product per layer over H * T. Each layer's maps are
sum-pooled over D; the pools feed a linear head, added to a deep MLP over
[dense; flat embeddings]. Served by
:func:`~hugectr_backend_tpu_torch.serving.program.make_xdeepfm_server`.

``compute_dtype`` (f32, or bf16) as in the JAX module: a CIN layer forms
its outer product in f32, casts it, contracts it with ``w`` cast to
``compute_dtype`` and returns f32 (so the next layer's ``x`` is f32); the
head ``Dense(1)`` over the f32 pools and the deep MLP run in
``compute_dtype``, and ``cin + deep`` is summed there before the f32 cast.
"""

from __future__ import annotations

import re
from typing import Sequence

import torch
from torch import nn

from hugectr_backend_tpu_torch.models.dlrm import (
    MLP,
    carry_dense,
    carry_mlp,
    carry_param,
    check_known,
    dense,
    flax_params,
    init_dense_,
    lecun_normal_,
    matmul_f32_sums,
)
from hugectr_backend_tpu_torch.models.quant_dense import mixed_operands


class CINLayer(nn.Module):
    """One compressed-interaction layer: ``forward(x [B, H, D], x0 [B, T, D])``
    -> [B, G, D] f32, the H x T pairwise products compressed to
    ``feature_maps`` (G) maps by ``w`` [G, H * T] (the Flax layout)."""

    def __init__(self, in_maps: int, num_feats: int, feature_maps: int = 64,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w = nn.Parameter(torch.empty(feature_maps, in_maps * num_feats))
        self.compute_dtype = compute_dtype

    def forward(self, x, x0, mixed_precision: bool = False):
        b, h, d = x.shape
        z = (x[:, :, None, :] * x0[:, None, :, :]).reshape(b, h * x0.shape[1], d)
        cd = self.compute_dtype
        if cd == torch.float32:
            w, z = mixed_operands(mixed_precision, self.w, z)
            return torch.matmul(w, z)  # [G, HT] @ [B, HT, D] -> [B, G, D]
        # Below f32 the operands are bf16 already (mixed_precision has
        # nothing left to round); f32 sums, rounded once, returned f32.
        return matmul_f32_sums(self.w.to(cd), z.to(cd)).float()


class XDeepFM(nn.Module):
    """``forward(dense [B, Nd], emb [B, T, D])`` -> logits [B]: the CIN head
    plus the deep MLP head, both over the shared embeddings."""

    def __init__(self, num_dense: int, num_feats: int, dim: int,
                 cin_feature_maps: Sequence[int] = (64, 64),
                 deep_widths: Sequence[int] = (400, 400, 1),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        ins = [num_feats, *cin_feature_maps[:-1]]
        self.cin = nn.ModuleList(CINLayer(h, num_feats, g, compute_dtype)
                                 for h, g in zip(ins, cin_feature_maps))
        self.cin_head = nn.Linear(sum(cin_feature_maps), 1)
        self.deep = MLP(num_dense + num_feats * dim, deep_widths, final_activation=False,
                        compute_dtype=compute_dtype)

    @torch.no_grad()
    def init_flax_(self, generator: torch.Generator) -> "XDeepFM":
        """Flax's initialisation, drawn from ``generator`` (module order).
        CIN's ``w`` takes its fan-in over H * T, the contracted axis, as the
        JAX package's ``lecun_normal(in_axis=-1)``."""
        for layer in self.cin:
            lecun_normal_(layer.w, layer.w.shape[1], generator)
        init_dense_(self.cin_head, generator)
        self.deep.init_flax_(generator)
        return self

    def forward(self, dense_x, emb, mixed_precision: bool = False):
        b = emb.shape[0]
        x = emb
        pools = []
        for layer in self.cin:
            x = layer(x, emb, mixed_precision)
            pools.append(x.sum(dim=2))  # [B, G]: sum-pool over D
        cin = dense(torch.cat(pools, dim=1), self.cin_head, mixed_precision,
                    compute_dtype=self.compute_dtype)
        deep = self.deep(torch.cat([dense_x.float(), emb.reshape(b, -1)], dim=1),
                         mixed_precision=mixed_precision)
        return (cin + deep).float().squeeze(-1)


_CIN = re.compile(r"CINLayer_(\d+)$")


def load_flax_xdeepfm_params(tree) -> dict:
    """Flax ``XDeepFM`` params (``CINLayer_i/w`` [G, H * T], ``Dense_0`` the
    CIN head, ``MLP_0`` deep) -> this module's state_dict (``weight =
    kernel.T``; ``w`` as it is). An unknown module name raises."""
    params = flax_params(tree)
    check_known(params, ["Dense_0", "MLP_0"] + [k for k in params if _CIN.match(k)],
                "XDeepFM")
    state: dict = {}
    for name, layer in params.items():
        m = _CIN.match(name)
        if m:
            check_known(layer, ["w"], name)
            carry_param(layer["w"], f"cin.{m.group(1)}.w", state)
    carry_dense(params["Dense_0"], "cin_head", state)
    carry_mlp(params["MLP_0"], "deep", state)
    return state
