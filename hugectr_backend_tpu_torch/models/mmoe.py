"""MMoE: multi-gate mixture of experts for multi-task CTR / CVR (KDD'18).

Port of the JAX package's models/mmoe.py. The experts run as one batched
stack: the entry layer maps [B, F] to [B, E, H1] (a ``DenseGeneral`` to
(E, H1) in Flax, one ``nn.Linear`` to E * H1 here), deeper layers use
per-expert kernels [E, H, W] contracted in one einsum. Per-task softmax
gates over the experts mix them (one einsum), and a tower MLP per task
gives a [B, num_tasks] logit matrix. Served by
:func:`~hugectr_backend_tpu_torch.serving.program.make_mmoe_server`.

``compute_dtype`` (f32, or bf16) as in the JAX module: the dense features
are cast to it and concatenated with the f32 embeddings, which promotes the
concat to f32 (``jnp.concatenate`` does the same), and the concat is cast to
it; the experts (kernels and biases cast), the gates with their softmax
(``jax.nn.softmax``'s roundings: :func:`~hugectr_backend_tpu_torch.models.dlrm.softmax`),
the mixture and the towers run in it; the logits come back f32.
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
    lecun_normal_,
    softmax,
)
from hugectr_backend_tpu_torch.models.quant_dense import mixed_operands


class MMoE(nn.Module):
    """``forward(dense [B, Nd], emb [B, T, D])`` -> logits [B, num_tasks].
    The input is ``[flat emb; dense]`` (embeddings first, as in the JAX
    package), of width T * D + Nd."""

    def __init__(self, num_dense: int, num_feats: int, dim: int, num_experts: int = 4,
                 num_tasks: int = 2, expert_widths: Sequence[int] = (128, 64),
                 tower_widths: Sequence[int] = (32, 1),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_experts, self.num_tasks = num_experts, num_tasks
        self.compute_dtype = compute_dtype
        width = num_feats * dim + num_dense
        self.experts_in = nn.Linear(width, num_experts * expert_widths[0])
        self.expert_kernels = nn.ParameterList(
            nn.Parameter(torch.empty(num_experts, h, w))
            for h, w in zip(expert_widths, expert_widths[1:]))
        self.expert_biases = nn.ParameterList(
            nn.Parameter(torch.empty(num_experts, w)) for w in expert_widths[1:])
        self.gates = nn.Linear(width, num_tasks * num_experts)
        self.towers = nn.ModuleList(
            MLP(expert_widths[-1], tower_widths, final_activation=False,
                compute_dtype=compute_dtype)
            for _ in range(num_tasks))

    @torch.no_grad()
    def init_flax_(self, generator: torch.Generator) -> "MMoE":
        """Flax's initialisation, drawn from ``generator``: ``lecun_normal``
        kernels (a per-expert kernel [E, H, W] with Flax's fan-in H * E),
        zero biases."""
        init_dense_(self.experts_in, generator)
        for k, b in zip(self.expert_kernels, self.expert_biases):
            lecun_normal_(k, k.shape[0] * k.shape[1], generator)
            nn.init.zeros_(b)
        init_dense_(self.gates, generator)
        for tower in self.towers:
            tower.init_flax_(generator)
        return self

    def forward(self, dense_x, emb, mixed_precision: bool = False):
        b = emb.shape[0]
        cd = self.compute_dtype
        # At bf16 the products take bf16 operands already: mixed_precision
        # has nothing left to round.
        mixed_precision = mixed_precision and cd == torch.float32
        x = torch.cat([emb.reshape(b, -1), dense_x.to(cd)], dim=1).to(cd)
        h = F.relu(dense(x, self.experts_in, mixed_precision, compute_dtype=cd))
        h = h.view(b, self.num_experts, -1)
        for k, bias in zip(self.expert_kernels, self.expert_biases):
            hm, km = mixed_operands(mixed_precision, h, k.to(cd))
            h = F.relu(torch.einsum("beh,ehw->bew", hm, km) + bias.to(cd)[None])
        gates = dense(x, self.gates, mixed_precision, compute_dtype=cd)
        gates = gates.view(b, self.num_tasks, self.num_experts)
        gates, hm = mixed_operands(mixed_precision, softmax(gates, dim=-1), h)
        mixed = torch.einsum("bke,bew->bkw", gates, hm)  # [B, K, W]
        return torch.cat([tower(mixed[:, t], mixed_precision=mixed_precision)
                          for t, tower in enumerate(self.towers)], dim=1).float()


_EXPERT = re.compile(r"expert_(kernel|bias)_(\d+)$")
_TOWER = re.compile(r"MLP_(\d+)$")


def load_flax_mmoe_params(tree) -> dict:
    """Flax ``MMoE`` params -> this module's state_dict: ``experts_in``
    (kernel [F, E, H1], bias [E, H1]) and ``gates`` (kernel [F, K, E], bias
    [K, E]) flattened over their output axes (``weight = kernel.T``),
    ``expert_kernel_i`` [E, H, W] and ``expert_bias_i`` [E, W] as they are,
    the towers ``MLP_0 .. MLP_{K-1}``. An unknown module name raises."""
    params = flax_params(tree)
    check_known(params, ["experts_in", "gates"]
                + [k for k in params if _EXPERT.match(k) or _TOWER.match(k)], "MMoE")
    state: dict = {}
    carry_dense(params["experts_in"], "experts_in", state)
    carry_dense(params["gates"], "gates", state)
    for name, a in params.items():
        m = _EXPERT.match(name)
        if m:
            group = {"kernel": "expert_kernels", "bias": "expert_biases"}[m.group(1)]
            carry_param(a, f"{group}.{m.group(2)}", state)
        m = _TOWER.match(name)
        if m:
            carry_mlp(a, f"towers.{m.group(1)}", state)
    return state
