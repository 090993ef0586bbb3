"""DCN-v2: deep & cross network with low-rank cross layers.

Port of the JAX package's models/dcn.py (BASELINE config 3 serves DCN-v2
with multi-table embeddings). A cross layer is two skinny products,
``x0 * V(U(x)) + x``; the cross stack and a deep MLP both read
``x0 = [dense; flat embeddings]``, and a head MLP reads their
concatenation. Served by
:func:`~hugectr_backend_tpu_torch.serving.program.make_dcn_server`.

``compute_dtype`` (f32, or bf16) is the JAX module's: ``x0`` is cast to it
after the concat, the cross layers' two products, ``x0 * v + x`` and both
MLPs run in it, and the logits come back f32.
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
    check_known,
    dense,
    flax_params,
    init_dense_,
)


class CrossLayerV2(nn.Module):
    """``forward(x0, x) = x0 * v(u(x)) + x`` with ``u``: width -> rank and
    ``v``: rank -> width, in ``compute_dtype``."""

    def __init__(self, width: int, rank: int = 64, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.u = nn.Linear(width, rank)
        self.v = nn.Linear(rank, width)
        self.compute_dtype = compute_dtype

    def forward(self, x0, x, mixed_precision: bool = False):
        cd = self.compute_dtype
        u = dense(x, self.u, mixed_precision, compute_dtype=cd)
        return x0 * dense(u, self.v, mixed_precision, compute_dtype=cd) + x


class DCNv2(nn.Module):
    """``forward(dense [B, Nd], emb [B, T, D])`` -> logits [B].
    ``num_dense``, ``num_feats`` (T) and ``dim`` (D) size the input width
    Nd + T * D, which Flax infers at init."""

    def __init__(self, num_dense: int, num_feats: int, dim: int,
                 num_cross_layers: int = 3, cross_rank: int = 64,
                 deep_widths: Sequence[int] = (1024, 512, 256),
                 head_widths: Sequence[int] = (128, 1),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        width = num_dense + num_feats * dim
        self.compute_dtype = compute_dtype
        self.cross = nn.ModuleList(CrossLayerV2(width, cross_rank, compute_dtype)
                                   for _ in range(num_cross_layers))
        self.deep = MLP(width, deep_widths, compute_dtype=compute_dtype)
        self.head = MLP(width + deep_widths[-1], head_widths, final_activation=False,
                        compute_dtype=compute_dtype)

    @torch.no_grad()
    def init_flax_(self, generator: torch.Generator) -> "DCNv2":
        """Flax's initialisation, drawn from ``generator`` (module order)."""
        for layer in self.cross:
            init_dense_(layer.u, generator)
            init_dense_(layer.v, generator)
        self.deep.init_flax_(generator)
        self.head.init_flax_(generator)
        return self

    def forward(self, dense_x, emb, mixed_precision: bool = False):
        x0 = torch.cat([dense_x.float(), emb.reshape(emb.shape[0], -1)],
                       dim=1).to(self.compute_dtype)
        x = x0
        for layer in self.cross:
            x = layer(x0, x, mixed_precision)
        deep = self.deep(x0, mixed_precision=mixed_precision)
        logits = self.head(torch.cat([x, deep], dim=1), mixed_precision=mixed_precision)
        return logits.float().squeeze(-1)


_CROSS = re.compile(r"CrossLayerV2_(\d+)$")


def load_flax_dcn_params(tree) -> dict:
    """Flax ``DCNv2`` params (``CrossLayerV2_i/Dense_{0,1}``, ``MLP_0`` deep,
    ``MLP_1`` head) -> this module's state_dict (``weight = kernel.T``). An
    unknown module name raises."""
    params = flax_params(tree)
    check_known(params, ["MLP_0", "MLP_1"] + [k for k in params if _CROSS.match(k)], "DCNv2")
    state: dict = {}
    for name, layer in params.items():
        m = _CROSS.match(name)
        if m:
            check_known(layer, ["Dense_0", "Dense_1"], name)
            carry_dense(layer["Dense_0"], f"cross.{m.group(1)}.u", state)
            carry_dense(layer["Dense_1"], f"cross.{m.group(1)}.v", state)
    carry_mlp(params["MLP_0"], "deep", state)
    carry_mlp(params["MLP_1"], "head", state)
    return state
