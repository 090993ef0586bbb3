"""Wide & Deep dense network.

Port of the JAX package's models/wdl.py: the wide table (vecsize 1)
contributes the sum of its scalar weights to the logit; the deep embeddings
and the dense features feed an MLP. Served by
:func:`~hugectr_backend_tpu_torch.serving.program.make_wdl_server`.
``compute_dtype`` (f32, or bf16) is the deep MLP's; its logit is cast to
f32 before the f32 wide sum is added, as in the JAX module.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from hugectr_backend_tpu_torch.models.dlrm import MLP, carry_mlp, check_known, flax_params


class WideAndDeep(nn.Module):
    """``forward(dense [B, Nd], wide_emb [B, Kw, 1], deep_emb [B, Kd, D])``
    -> logits [B]. ``num_dense``, ``deep_keys`` and ``dim`` size the deep
    MLP's input (Nd + Kd * D), which Flax infers at init."""

    def __init__(self, num_dense: int, deep_keys: int, dim: int,
                 deep_widths: Sequence[int] = (1024, 512, 256, 1),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.deep = MLP(num_dense + deep_keys * dim, deep_widths, final_activation=False,
                        compute_dtype=compute_dtype)

    def init_flax_(self, generator: torch.Generator) -> "WideAndDeep":
        """Flax's initialisation, drawn from ``generator``."""
        self.deep.init_flax_(generator)
        return self

    def forward(self, dense, wide_emb, deep_emb, mixed_precision: bool = False):
        b = dense.shape[0]
        wide = wide_emb.reshape(b, -1).sum(dim=1)
        deep_in = torch.cat([dense.float(), deep_emb.reshape(b, -1)], dim=1)
        deep = self.deep(deep_in, mixed_precision=mixed_precision).float().squeeze(-1)
        return wide + deep


def load_flax_wdl_params(tree) -> dict:
    """Flax ``WideAndDeep`` params (``MLP_0/Dense_i``) -> this module's
    state_dict (``weight = kernel.T``). An unknown module name raises."""
    params = flax_params(tree)
    check_known(params, ["MLP_0"], "WideAndDeep")
    state: dict = {}
    carry_mlp(params["MLP_0"], "deep", state)
    return state
