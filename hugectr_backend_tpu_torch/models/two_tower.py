"""Two-tower retrieval: the user (query) tower.

Port of the JAX package's models/two_tower.py. The item tower is the
embedding table itself: :class:`~hugectr_backend_tpu_torch.serving.retrieval.
RetrievalServer` scores the query against every resident item row and
keeps the top k.

``compute_dtype`` (f32, or bf16) as in the JAX module: the dense features
are cast to it and concatenated with the f32 user rows (the concat promotes
to f32), the MLP casts that, the L2 normalisation runs in ``compute_dtype``
with the roundings of ``jnp.linalg.norm`` as XLA compiles it
(:func:`~hugectr_backend_tpu_torch.models.dlrm.l2_normalize`), and the
queries come back in it.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from hugectr_backend_tpu_torch.models.dlrm import (
    MLP,
    carry_mlp,
    check_known,
    flax_params,
    l2_normalize,
)


class TwoTowerUser(nn.Module):
    """``forward(dense [B, Nd], user_emb [B, K_u, D_u])`` -> queries [B, dim]
    over ``[flat user_emb; dense]``; ``widths[-1]`` must equal the item
    embedding dim. ``normalize`` makes the queries unit-norm (cosine
    scores against unit-norm items). The queries are in ``compute_dtype``."""

    def __init__(self, num_dense: int, user_keys: int, dim: int,
                 widths: Sequence[int] = (256, 128), normalize: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.normalize = normalize
        self.compute_dtype = compute_dtype
        self.mlp = MLP(user_keys * dim + num_dense, widths, final_activation=False,
                       compute_dtype=compute_dtype)

    def init_flax_(self, generator: torch.Generator) -> "TwoTowerUser":
        """Flax's initialisation, drawn from ``generator``."""
        self.mlp.init_flax_(generator)
        return self

    def forward(self, dense, user_emb):
        b = user_emb.shape[0]
        q = self.mlp(torch.cat([user_emb.reshape(b, -1), dense.to(self.compute_dtype)], dim=1))
        if self.normalize:
            q = l2_normalize(q)
        return q


def load_flax_two_tower_params(tree) -> dict:
    """Flax ``TwoTowerUser`` params (``MLP_0/Dense_i``) -> this module's
    state_dict (``weight = kernel.T``). An unknown module name raises."""
    params = flax_params(tree)
    check_known(params, ["MLP_0"], "TwoTowerUser")
    state: dict = {}
    carry_mlp(params["MLP_0"], "mlp", state)
    return state
