"""NCF / NeuMF dense network (GMF + MLP heads over user and item embeddings).

Port of the JAX package's models/ncf.py. Two tables, users and items, one
key each per sample::

    gmf = u * v
    mlp = MLP([dense; u; v])
    y   = Dense(1)([gmf; mlp])

Served by :func:`~hugectr_backend_tpu_torch.serving.program.make_ncf_server`.
``compute_dtype`` (f32, or bf16) as in the JAX module: ``gmf`` stays f32,
the MLP runs in ``compute_dtype`` and is cast to f32 for the concat, and the
head ``Dense(1)`` runs in ``compute_dtype`` over that f32 concat.
"""

from __future__ import annotations

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


class NCF(nn.Module):
    """``forward(dense [B, Nd] (Nd may be 0), user_emb [B, 1, D],
    item_emb [B, 1, D])`` -> logits [B]."""

    def __init__(self, num_dense: int, dim: int, mlp_widths: Sequence[int] = (256, 128, 64),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.mlp = MLP(num_dense + 2 * dim, mlp_widths, compute_dtype=compute_dtype)
        self.head = nn.Linear(dim + mlp_widths[-1], 1)

    def init_flax_(self, generator: torch.Generator) -> "NCF":
        """Flax's initialisation, drawn from ``generator`` (module order)."""
        self.mlp.init_flax_(generator)
        with torch.no_grad():
            init_dense_(self.head, generator)
        return self

    def forward(self, dense_x, user_emb, item_emb, mixed_precision: bool = False):
        b = user_emb.shape[0]
        u = user_emb.reshape(b, -1)
        v = item_emb.reshape(b, -1)
        gmf = u * v
        mlp = self.mlp(torch.cat([dense_x.float(), u, v], dim=1),
                       mixed_precision=mixed_precision)
        y = dense(torch.cat([gmf, mlp.float()], dim=1), self.head, mixed_precision,
                  compute_dtype=self.compute_dtype)
        return y.float().squeeze(-1)


def load_flax_ncf_params(tree) -> dict:
    """Flax ``NCF`` params (``MLP_0``, ``Dense_0``) -> this module's
    state_dict (``weight = kernel.T``). An unknown module name raises."""
    params = flax_params(tree)
    check_known(params, ["MLP_0", "Dense_0"], "NCF")
    state: dict = {}
    carry_mlp(params["MLP_0"], "mlp", state)
    carry_dense(params["Dense_0"], "head", state)
    return state
