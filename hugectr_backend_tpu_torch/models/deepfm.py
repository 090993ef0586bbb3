"""DeepFM dense network (FM second-order term + deep MLP over embeddings).

Port of the JAX package's models/deepfm.py::

    y = sum(first-order weights)
      + 0.5 * sum_d[(sum_f v_fd)^2 - sum_f v_fd^2]     (FM second order)
      + MLP([dense; flat embeddings])

The FM term is two reductions over the embeddings; the MLP shares them
(the defining DeepFM weight sharing). Served by
:func:`~hugectr_backend_tpu_torch.serving.program.make_deepfm_server`.
``compute_dtype`` (f32, or bf16) is the deep MLP's; the first-order and FM
terms stay in the embeddings' f32 and the deep logit is cast to f32 before
the sum, as in the JAX module.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from hugectr_backend_tpu_torch.models.dlrm import MLP, carry_mlp, check_known, flax_params


class DeepFM(nn.Module):
    """``forward(dense [B, Nd], first_emb [B, T, 1], emb [B, T, D])`` ->
    logits [B]. ``first_emb``: per-feature first-order weights (a vecsize-1
    table); ``emb``: the second-order vectors, shared with the deep half."""

    def __init__(self, num_dense: int, num_feats: int, dim: int,
                 deep_widths: Sequence[int] = (400, 400, 1),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.deep = MLP(num_dense + num_feats * dim, deep_widths, final_activation=False,
                        compute_dtype=compute_dtype)

    def init_flax_(self, generator: torch.Generator) -> "DeepFM":
        """Flax's initialisation, drawn from ``generator``."""
        self.deep.init_flax_(generator)
        return self

    def forward(self, dense, first_emb, emb, mixed_precision: bool = False):
        b = dense.shape[0]
        first = first_emb.reshape(b, -1).sum(dim=1)
        s = emb.sum(dim=1)  # [B, D]: the sum over features
        fm = 0.5 * (s * s - (emb * emb).sum(dim=1)).sum(dim=1)
        deep_in = torch.cat([dense.float(), emb.reshape(b, -1)], dim=1)
        deep = self.deep(deep_in, mixed_precision=mixed_precision).float().squeeze(-1)
        return first.float() + fm.float() + deep


def load_flax_deepfm_params(tree) -> dict:
    """Flax ``DeepFM`` params (``MLP_0/Dense_i``) -> this module's state_dict
    (``weight = kernel.T``). An unknown module name raises."""
    params = flax_params(tree)
    check_known(params, ["MLP_0"], "DeepFM")
    state: dict = {}
    carry_mlp(params["MLP_0"], "deep", state)
    return state
