"""BST: Behavior Sequence Transformer (Alibaba, arXiv:1905.06874 shape).

Port of the JAX package's models/bst.py. The behaviour sequence plus the
target item as the last token make a [B, S+1, D] block, with learned
positional embeddings; ``num_layers`` post-LN encoder blocks attend with a
padding mask from ``seq_len`` (the target token is always live), a masked
mean over the live tokens feeds the MLP head. The call signature ``(dense,
target, seq, seq_len)`` is DIN's, so
:class:`~hugectr_backend_tpu_torch.serving.pooled.FusedDinServer` serves both.
Flax's ``LayerNorm`` epsilon (1e-6) is kept.

``compute_dtype`` (f32, or bf16) as in the JAX module: the tokens and the
positional embeddings are cast to it and added in it; q / k / v, the
attention logits (divided by ``sqrt`` of ``dk`` taken in ``compute_dtype``:
5.65625 for dk 32 in bf16), the mask value (-998,244,352 in bf16), the
softmax (``jax.nn.softmax``'s roundings:
:func:`~hugectr_backend_tpu_torch.models.dlrm.softmax`), the output and
feed-forward layers and the masked mean run in it;
``LayerNorm`` computes in f32 with its f32 scale and bias and returns
``compute_dtype`` (Flax's ``LayerNorm(dtype=...)``); ``[pooled; dense]`` is
cast to it for the head, and the logits come back f32.
"""

from __future__ import annotations

import re
from typing import Sequence

import torch
import torch.nn.functional as F
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
    matmul_f32_sums,
    softmax,
)

_NEG = -1e9  # mask value (finite: -inf would NaN a fully-masked row)
_LN_EPS = 1e-6  # Flax's LayerNorm default


class _EncoderBlock(nn.Module):
    """``forward(x [B, T, D], live [B, T] bool)``: dead tokens never serve
    as keys."""

    def __init__(self, dim: int, num_heads: int, ff_mult: int = 4,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.q, self.k, self.v, self.o = (nn.Linear(dim, dim) for _ in range(4))
        self.norm1 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.ff1 = nn.Linear(dim, ff_mult * dim)
        self.ff2 = nn.Linear(ff_mult * dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=_LN_EPS)

    @torch.no_grad()
    def init_flax_(self, generator: torch.Generator) -> None:
        for layer in (self.q, self.k, self.v, self.o, self.ff1, self.ff2):
            init_dense_(layer, generator)
        for norm in (self.norm1, self.norm2):
            nn.init.ones_(norm.weight)
            nn.init.zeros_(norm.bias)

    def _dense(self, x, layer):
        return dense(x, layer, compute_dtype=self.compute_dtype)

    def _norm(self, x, norm):
        return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                            norm.eps).to(self.compute_dtype)

    def forward(self, x, live):
        b, t, d = x.shape
        h = self.num_heads
        q, k, v = (self._dense(x, layer).view(b, t, h, d // h).transpose(1, 2)
                   for layer in (self.q, self.k, self.v))  # [B, h, T, dk]
        # The square root of dk in compute_dtype, as jnp.sqrt takes it; a
        # 0-dim host tensor divides as a Python number does, also on the card.
        root = torch.tensor(d // h, dtype=self.compute_dtype).sqrt()
        logits = matmul_f32_sums(q, k.transpose(-1, -2)) / root
        logits = logits.masked_fill(~live[:, None, None, :], _NEG)
        ctx = matmul_f32_sums(softmax(logits, dim=-1), v).transpose(1, 2).reshape(b, t, d)
        x = self._norm(x + self._dense(ctx, self.o), self.norm1)
        return self._norm(x + self._dense(F.relu(self._dense(x, self.ff1)), self.ff2),
                          self.norm2)


class BST(nn.Module):
    """``forward(dense [B, Nd], target_emb [B, D], seq_emb [B, S, D],
    seq_len [B])`` -> logits [B]. ``max_len`` is S: the positional
    embeddings ``pos_emb`` [S+1, D] are learned for that length (Flax
    infers it at init)."""

    def __init__(self, num_dense: int, dim: int, max_len: int, num_heads: int = 4,
                 num_layers: int = 1, head_widths: Sequence[int] = (256, 64, 1),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"embedding dim {dim} must divide num_heads {num_heads}")
        self.compute_dtype = compute_dtype
        self.pos_emb = nn.Parameter(torch.empty(max_len + 1, dim))
        self.blocks = nn.ModuleList(_EncoderBlock(dim, num_heads, compute_dtype=compute_dtype)
                                    for _ in range(num_layers))
        self.head = MLP(dim + num_dense, head_widths, final_activation=False,
                        compute_dtype=compute_dtype)

    @torch.no_grad()
    def init_flax_(self, generator: torch.Generator) -> "BST":
        """Flax's initialisation, drawn from ``generator``: ``pos_emb`` a
        normal of std 0.02, ``lecun_normal`` kernels, zero biases, unit
        LayerNorm scales."""
        nn.init.normal_(self.pos_emb, 0.0, 0.02, generator=generator)
        for block in self.blocks:
            block.init_flax_(generator)
        self.head.init_flax_(generator)
        return self

    def forward(self, dense, target_emb, seq_emb, seq_len):
        b, s, d = seq_emb.shape
        if s + 1 != self.pos_emb.shape[0]:
            raise ValueError(f"sequence length {s}: the positional embeddings were "
                             f"learned for {self.pos_emb.shape[0] - 1}")
        cd = self.compute_dtype
        tokens = torch.cat([seq_emb, target_emb[:, None, :]], dim=1).to(cd)
        tokens = tokens + self.pos_emb[None].to(cd)
        live = torch.cat([
            torch.arange(s, device=seq_emb.device)[None, :] < seq_len[:, None],
            torch.ones((b, 1), dtype=torch.bool, device=seq_emb.device),  # the target token
        ], dim=1)
        for block in self.blocks:
            tokens = block(tokens, live)
        # Masked mean over the live tokens (at least the target); dead query
        # rows hold finite values that the mask drops here.
        m = live.to(cd)[..., None]
        pooled = (tokens * m).sum(dim=1) / m.sum(dim=1)
        return self.head(torch.cat([pooled, dense.to(cd)], dim=1)).float().squeeze(-1)


_BLOCK = re.compile(r"_EncoderBlock_(\d+)$")
_BLOCK_DENSE = {"q": "q", "k": "k", "v": "v", "o": "o", "Dense_0": "ff1", "Dense_1": "ff2"}
_BLOCK_NORM = {"LayerNorm_0": "norm1", "LayerNorm_1": "norm2"}


def load_flax_bst_params(tree) -> dict:
    """Flax ``BST`` params -> this module's state_dict: ``pos_emb`` [S+1, D]
    as it is; per ``_EncoderBlock_i`` the ``DenseGeneral`` kernels ``q``,
    ``k``, ``v`` [D, h, dk] (bias [h, dk]) flattened to [D, D] and, like
    ``o``, ``Dense_0`` and ``Dense_1``, transposed (``weight = kernel.T``),
    ``LayerNorm_{0,1}`` ``scale`` -> ``weight``; ``MLP_0`` the head. An
    unknown module name raises."""
    params = flax_params(tree)
    check_known(params, ["pos_emb", "MLP_0"] + [k for k in params if _BLOCK.match(k)], "BST")
    state: dict = {}
    carry_param(params["pos_emb"], "pos_emb", state)
    for name, block in params.items():
        m = _BLOCK.match(name)
        if not m:
            continue
        check_known(block, [*_BLOCK_DENSE, *_BLOCK_NORM], name)
        key = f"blocks.{m.group(1)}"
        for flax_name, ours in _BLOCK_DENSE.items():
            carry_dense(block[flax_name], f"{key}.{ours}", state)
        for flax_name, ours in _BLOCK_NORM.items():
            carry_param(block[flax_name]["scale"], f"{key}.{ours}.weight", state)
            carry_param(block[flax_name]["bias"], f"{key}.{ours}.bias", state)
    carry_mlp(params["MLP_0"], "head", state)
    return state
