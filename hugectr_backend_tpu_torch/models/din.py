"""DIN-style sequence recsys: attention-pooled variable-length behaviour lookups.

Port of the JAX package's models/din.py (BASELINE config 4). The variable
length arrives as a padded sequence [B, S, D] and a length vector
``seq_len`` [B]; masking keeps the shapes static. Served by
:class:`~hugectr_backend_tpu_torch.serving.pooled.FusedDinServer`.
``compute_dtype`` (f32, or bf16) is the two MLPs', as in the JAX module: the
attention MLP casts its f32 features, its score comes back f32 for the mask
and the softmax, the pooling runs in f32, and the head MLP casts its f32
input.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from hugectr_backend_tpu_torch.models.dlrm import MLP, carry_mlp, check_known, flax_params


class DinAttentionPool(nn.Module):
    """Target-aware attention over the behaviour sequence:
    ``forward(target [B, D], seq [B, S, D], seq_len [B])`` -> pooled [B, D].

    The scores of dead positions are -1e9 before the softmax, and the
    weights are masked again after it: for ``seq_len == 0`` every score is
    -1e9 and the softmax alone would average the padding positions
    uniformly, so an empty history pools to zeros instead."""

    def __init__(self, dim: int, hidden: int = 64, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mlp = MLP(4 * dim, (hidden, 1), final_activation=False,
                       compute_dtype=compute_dtype)

    def forward(self, target, seq, seq_len):
        b, s, d = seq.shape
        t = target[:, None, :].expand(b, s, d)
        feats = torch.cat([t, seq, t - seq, t * seq], dim=-1)
        score = self.mlp(feats).float().squeeze(-1)  # [B, S]
        mask = torch.arange(s, device=seq.device)[None, :] < seq_len[:, None]
        score = score.masked_fill(~mask, -1e9)
        w = torch.softmax(score, dim=-1) * mask.float()
        return torch.einsum("bs,bsd->bd", w, seq.float())


class DIN(nn.Module):
    """``forward(dense [B, Nd], target_emb [B, D], seq_emb [B, S, D],
    seq_len [B])`` -> logits [B]: the MLP over [dense; target; pooled]."""

    def __init__(self, num_dense: int, dim: int, mlp_widths: Sequence[int] = (200, 80, 1),
                 att_hidden: int = 64, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attention = DinAttentionPool(dim, att_hidden, compute_dtype)
        self.mlp = MLP(num_dense + 2 * dim, mlp_widths, final_activation=False,
                       compute_dtype=compute_dtype)

    def init_flax_(self, generator: torch.Generator) -> "DIN":
        """Flax's initialisation, drawn from ``generator`` (module order)."""
        self.attention.mlp.init_flax_(generator)
        self.mlp.init_flax_(generator)
        return self

    def forward(self, dense, target_emb, seq_emb, seq_len):
        pooled = self.attention(target_emb, seq_emb, seq_len)
        x = torch.cat([dense.float(), target_emb, pooled], dim=1)
        return self.mlp(x).float().squeeze(-1)


def load_flax_din_params(tree) -> dict:
    """Flax ``DIN`` params (``DinAttentionPool_0/MLP_0``, ``MLP_0``) -> this
    module's state_dict (``weight = kernel.T``). An unknown module name
    raises."""
    params = flax_params(tree)
    check_known(params, ["DinAttentionPool_0", "MLP_0"], "DIN")
    check_known(params["DinAttentionPool_0"], ["MLP_0"], "DinAttentionPool_0")
    state: dict = {}
    carry_mlp(params["DinAttentionPool_0"]["MLP_0"], "attention.mlp", state)
    carry_mlp(params["MLP_0"], "mlp", state)
    return state
