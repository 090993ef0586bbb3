"""DLRM dense network (bottom MLP + pairwise interaction + top MLP).

Port of the JAX package's models/dlrm.py as ``nn.Module``s. The MLPs are
plain ``nn.Linear`` layers in f32 (the JAX package leaves them to XLA). The
interaction runs on the kernels of ops/fused_interaction.py: K3 when the
embeddings carry a folded one-hot group, K2 otherwise; a stacked
``[B, T, D]`` tensor goes to K2 as strided feature views. Like the Pallas
bodies, the kernels round z to bf16 and sum the products in f32.
``DotInteraction(self_interaction=True)`` stays plain f32 PyTorch: the JAX
package has no kernel for it either.

:func:`load_flax_dlrm_params` carries a Flax checkpoint across, so one set of
weights serves in both packages.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hugectr_backend_tpu_torch.ops.fused_interaction import (
    EmbParts,
    dot_interaction_oh_parts,
    dot_interaction_parts,
)


class MLP(nn.Module):
    """ReLU MLP; the last layer's activation is optional."""

    def __init__(self, in_features: int, widths: Sequence[int],
                 final_activation: bool = True):
        super().__init__()
        dims = [in_features, *widths]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:]))
        self.final_activation = final_activation

    def forward(self, x: torch.Tensor,
                first_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``first_weight`` replaces layer 0's weight (the serving path's
        column-permuted copy for a reordered interaction)."""
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            w = first_weight if i == 0 and first_weight is not None else layer.weight
            x = F.linear(x, w, layer.bias)
            if i + 1 < n or self.final_activation:
                x = F.relu(x)
        return x


class DotInteraction(nn.Module):
    """DLRM pairwise-dot feature interaction: ``[bottom, triu(Z Z^T)]`` with
    Z = [bottom; emb_1..emb_T] (k = 1, or k = 0 with ``self_interaction``).
    ``emb`` is a stacked [B, T, D] tensor or an :class:`EmbParts`."""

    def __init__(self, self_interaction: bool = False):
        super().__init__()
        self.self_interaction = self_interaction

    def forward(self, bottom: torch.Tensor, emb) -> torch.Tensor:
        if self.self_interaction:
            if isinstance(emb, EmbParts):
                raise ValueError("self_interaction takes a stacked [B, T, D] tensor")
            z = torch.cat([bottom[:, None, :], emb.to(bottom.dtype)], dim=1)
            zzt = torch.bmm(z, z.transpose(1, 2))
            f = z.shape[1]
            r, c = torch.triu_indices(f, f, 0, device=z.device)
            return torch.cat([bottom, zzt[:, r, c]], dim=1)
        if isinstance(emb, EmbParts):
            if emb.oh is not None:
                values, slots, scales, _members = emb.oh
                return dot_interaction_oh_parts(bottom, values, slots, scales,
                                                emb.parts, emb.feature_map)
            return dot_interaction_parts(bottom, emb.parts, emb.feature_map)
        emb = emb.to(bottom.dtype)
        return dot_interaction_parts(bottom, [emb.transpose(0, 1)],
                                     [(0, t) for t in range(emb.shape[1])])


class DLRM(nn.Module):
    """Facebook-style DLRM dense graph consuming HPS lookup output.

    ``forward(dense, emb)``: dense [B, num_dense], emb [B, T, D] or
    :class:`EmbParts` (one vector per table per sample) -> logits [B]
    (``top_widths[-1] == 1``). ``num_dense`` and ``num_tables`` size the
    first layers, which Flax infers at init."""

    def __init__(self, num_dense: int, num_tables: int,
                 bottom_widths: Sequence[int] = (512, 256, 64),
                 top_widths: Sequence[int] = (1024, 1024, 512, 256, 1)):
        super().__init__()
        self.bottom_widths = tuple(bottom_widths)
        self.top_widths = tuple(top_widths)
        dim = self.bottom_widths[-1]
        feats = num_tables + 1
        self.bottom = MLP(num_dense, bottom_widths, final_activation=True)
        self.interaction = DotInteraction()
        self.top = MLP(dim + feats * (feats - 1) // 2, top_widths,
                       final_activation=False)

    def forward(self, dense: torch.Tensor, emb,
                top_weight0: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.bottom_widths[-1] != emb.shape[-1]:
            raise ValueError(
                f"DLRM bottom MLP must end at the embedding dim for the dot "
                f"interaction: bottom_widths[-1]={self.bottom_widths[-1]} vs "
                f"embedding dim {emb.shape[-1]}"
            )
        bottom = self.bottom(dense.float())
        x = self.interaction(bottom, emb)
        return self.top(x, first_weight=top_weight0).float().squeeze(-1)


def load_flax_dlrm_params(tree) -> dict:
    """Flax DLRM params (``params/MLP_{0,1}/Dense_i/{kernel,bias}``, any
    array type numpy can read) -> this package's ``DLRM`` state_dict
    (``weight = kernel.T``)."""
    params = tree["params"] if "params" in tree else tree
    state = {}
    for mod, prefix in (("MLP_0", "bottom"), ("MLP_1", "top")):
        layers = params[mod]
        unknown = [k for k in layers if not k.startswith("Dense_")]
        if unknown:
            raise NotImplementedError(
                f"{mod} holds {unknown}: quantized dense layers are ROADMAP "
                "queue A item 4")
        for i in range(len(layers)):
            layer = layers[f"Dense_{i}"]
            kernel = np.asarray(layer["kernel"], dtype=np.float32)
            state[f"{prefix}.layers.{i}.weight"] = torch.from_numpy(
                np.array(kernel.T, order="C"))
            state[f"{prefix}.layers.{i}.bias"] = torch.from_numpy(
                np.array(layer["bias"], dtype=np.float32))
    return state
