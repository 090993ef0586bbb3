"""DLRM dense network (bottom MLP + pairwise interaction + top MLP).

Port of the JAX package's models/dlrm.py as ``nn.Module``s. The MLPs are
plain ``nn.Linear`` layers in f32 (the JAX package leaves them to XLA), or
with ``quant_fmt`` set, :class:`~hugectr_backend_tpu_torch.models.quant_dense.QuantDense`
layers with the activation fused in (w8a8 runs K5). With
``mixed_precision`` the f32 and weight-only products take bf16 operands and
accumulate in f32. ``compute_dtype`` (f32 by default, or bf16) is the JAX
modules' own: the MLPs cast their input to it and compute each layer as
Flax's ``nn.Dense`` does in it (:func:`dense`: the product summed in f32
and rounded once, then the bias added in that type), the embeddings are
cast to the bottom's type before the interaction, whose kernels then take
and write bf16, and the logits come back in f32. The interaction runs on
the kernels of ops/fused_interaction.py: K3 when the embeddings carry a
folded one-hot group (forward-only), K2 for other chunked embeddings, K4
for a stacked ``[B, T, D]`` tensor. Like the Pallas bodies, the kernels round z to bf16
and sum the products in f32; K2 and K4 are differentiable (their backward
kernel uses the f32 z, as the JAX package's VJP does), so the training path
runs on them. ``DotInteraction(self_interaction=True)`` stays plain f32
PyTorch: the JAX package has no kernel for it either.

:meth:`DLRM.init_flax_` draws Flax's initialisation (``lecun_normal``
kernels, zero biases) from an explicit generator; :func:`load_flax_dlrm_params`
carries a Flax checkpoint across, so one set of weights serves in both
packages.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hugectr_backend_tpu_torch.ops.fused_interaction import (
    EmbParts,
    dot_interaction_oh_parts,
    dot_interaction_parts,
    fused_dot_interaction,
    full_f32_matmul,
)

# Flax's lecun_normal: a normal truncated at +-2 std, scaled so that the
# truncated distribution has variance 1 / fan_in (the std of a unit normal
# truncated at +-2 is 0.87962566103423978).
_TRUNC_STD = 0.87962566103423978
from hugectr_backend_tpu_torch.models.quant_dense import QuantDense, linear


class MLP(nn.Module):
    """ReLU MLP; the last layer's activation is optional. ``quant_fmt``
    (None, "int8", "fp8" or "w8a8") makes every layer a :class:`QuantDense`
    with its activation fused in, as in the JAX package."""

    def __init__(self, in_features: int, widths: Sequence[int],
                 final_activation: bool = True, quant_fmt: Optional[str] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = [in_features, *widths]
        n = len(widths)
        acts = ["relu" if i + 1 < n or final_activation else None for i in range(n)]
        if quant_fmt:
            self.layers = nn.ModuleList(
                QuantDense(a, b, quant_fmt, activation=act, compute_dtype=compute_dtype)
                for a, b, act in zip(dims, dims[1:], acts))
        else:
            self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims, dims[1:]))
        self.acts = acts
        self.quant_fmt = quant_fmt
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor, first_weight: Optional[torch.Tensor] = None,
                mixed_precision: bool = False) -> torch.Tensor:
        """``first_weight`` replaces layer 0's weight, or its ``kernel_q``
        for a quantized layer (the serving path's column-permuted copy for a
        reordered interaction). ``x`` is cast to ``compute_dtype`` first."""
        x = x.to(self.compute_dtype)
        for i, (layer, act) in enumerate(zip(self.layers, self.acts)):
            w = first_weight if i == 0 else None
            if self.quant_fmt:
                x = layer(x, kernel_q=w, mixed_precision=mixed_precision)
                continue
            x = dense(x, layer, mixed_precision, weight=w, compute_dtype=self.compute_dtype)
            if act:
                x = F.relu(x)
        return x

    @torch.no_grad()
    def init_flax_(self, generator: torch.Generator) -> "MLP":
        """Flax's ``nn.Dense`` init from ``generator``: see :func:`init_dense_`."""
        if self.quant_fmt:
            raise ValueError("a quantized MLP is built from trained weights; "
                             "init the f32 model and quantize_model_params it")
        for layer in self.layers:
            init_dense_(layer, generator)
        return self


def dense(x: torch.Tensor, layer: nn.Linear, mixed_precision: bool = False,
          weight: Optional[torch.Tensor] = None,
          compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``layer(x)``, its product under :func:`~hugectr_backend_tpu_torch.models.
    quant_dense.mixed_operands`; ``weight`` replaces the layer's. With a
    ``compute_dtype`` other than f32, Flax's ``nn.Dense(dtype=...)`` over f32
    parameters: the input and weight cast to that type, their product summed
    in f32 and rounded once (:func:`matmul_f32_sums`), then the bias, cast
    too, added in that type."""
    w = layer.weight if weight is None else weight
    if compute_dtype != torch.float32:
        y = matmul_f32_sums(x.to(compute_dtype), w.to(compute_dtype).T)
        return y + layer.bias.to(compute_dtype)
    if mixed_precision:
        return linear(x, w, mixed_precision=True) + layer.bias
    return F.linear(x, w, layer.bias)


def matmul_f32_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two tensors of one type below f32 (2-D, or batched over
    leading axes as ``torch.matmul`` takes them) as the JAX package computes
    a product in that type: the products exact, summed in f32, the sum
    rounded once to the operands' type. The operands are exact in f32, so
    this is their f32 product (an SGEMM on the card, TF32 held off whatever
    the caller set), whose fused multiply-adds round as the CPU's do. On f32
    operands it is ``torch.matmul`` in full f32.
    ``torch.mm(..., out_dtype=torch.float32)`` on the tensor cores also sums
    in f32 and is faster, but its results part from the CPU's several times
    as often (PERF.md)."""
    with full_f32_matmul():
        return torch.matmul(a.float(), b.float()).to(a.dtype)


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.softmax`` in f32. Below f32, ``jax.nn.softmax``'s steps, each
    rounded to ``x``'s type: ``exp(x - max)``, its sum (f32 inside), the
    quotient; ``torch.softmax`` would round once at the end."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim=dim)
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


def l2_normalize(q: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """``q / (||q|| + eps)`` over the last axis. Below f32 with the roundings
    of ``jnp.linalg.norm`` as XLA compiles it: the squares summed in f32, the
    sum rounded to ``q``'s type, then the root; ``vector_norm`` would round
    once, after the root."""
    if q.dtype == torch.float32:
        norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    else:
        norm = q.float().square().sum(dim=-1, keepdim=True).to(q.dtype).sqrt()
    return q / (norm + eps)


def lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """Flax's ``lecun_normal``: a normal truncated at +-2 of its std, scaled
    so that the truncated distribution has variance 1 / fan_in."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_dense_(layer: nn.Linear, generator: torch.Generator) -> None:
    """Flax's ``nn.Dense`` / ``DenseGeneral`` init: ``lecun_normal`` over the
    input features, zero bias."""
    lecun_normal_(layer.weight, layer.in_features, generator)
    nn.init.zeros_(layer.bias)


class DotInteraction(nn.Module):
    """DLRM pairwise-dot feature interaction: ``[bottom, triu(Z Z^T)]`` with
    Z = [bottom; emb_1..emb_T] (k = 1, or k = 0 with ``self_interaction``).
    ``emb`` is a stacked [B, T, D] tensor (K4) or an :class:`EmbParts` (K2,
    or K3 with a folded one-hot group, which is forward-only)."""

    def __init__(self, self_interaction: bool = False):
        super().__init__()
        self.self_interaction = self_interaction

    def forward(self, bottom: torch.Tensor, emb) -> torch.Tensor:
        if self.self_interaction:
            if isinstance(emb, EmbParts):
                raise ValueError("self_interaction takes a stacked [B, T, D] tensor")
            z = torch.cat([bottom[:, None, :], emb.to(bottom.dtype)], dim=1)
            zzt = matmul_f32_sums(z, z.transpose(1, 2))  # below f32: f32 sums, one rounding
            f = z.shape[1]
            r, c = torch.triu_indices(f, f, 0, device=z.device)
            return torch.cat([bottom, zzt[:, r, c]], dim=1)
        if isinstance(emb, EmbParts):
            if any(p.dtype != bottom.dtype for p in emb.parts):
                emb = emb.astype(bottom.dtype)
            if emb.oh is not None:
                values, slots, scales, members = emb.oh
                return dot_interaction_oh_parts(bottom, values, slots, scales,
                                                emb.parts, emb.feature_map, members)
            return dot_interaction_parts(bottom, emb.parts, emb.feature_map)
        return fused_dot_interaction(bottom, emb.to(bottom.dtype))


class DLRM(nn.Module):
    """Facebook-style DLRM dense graph consuming HPS lookup output.

    ``forward(dense, emb)``: dense [B, num_dense], emb [B, T, D] or
    :class:`EmbParts` (one vector per table per sample) -> logits [B]
    (``top_widths[-1] == 1``). ``num_dense`` and ``num_tables`` size the
    first layers, which Flax infers at init."""

    def __init__(self, num_dense: int, num_tables: int,
                 bottom_widths: Sequence[int] = (512, 256, 64),
                 top_widths: Sequence[int] = (1024, 1024, 512, 256, 1),
                 quant_fmt: Optional[str] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_dense, self.num_tables = num_dense, num_tables
        self.bottom_widths = tuple(bottom_widths)
        self.top_widths = tuple(top_widths)
        self.quant_fmt = quant_fmt
        self.compute_dtype = compute_dtype
        dim = self.bottom_widths[-1]
        feats = num_tables + 1
        self.bottom = MLP(num_dense, bottom_widths, final_activation=True,
                          quant_fmt=quant_fmt, compute_dtype=compute_dtype)
        self.interaction = DotInteraction()
        self.top = MLP(dim + feats * (feats - 1) // 2, top_widths,
                       final_activation=False, quant_fmt=quant_fmt,
                       compute_dtype=compute_dtype)

    @torch.no_grad()
    def init_flax_(self, generator: torch.Generator) -> "DLRM":
        """Flax's initialisation of ``nn.Dense``, drawn from ``generator``:
        kernels ``lecun_normal`` (a normal truncated at +-2 of its std,
        variance 1 / fan_in), biases zero. Quantized layers have no init of
        their own (they are built from trained weights) and raise."""
        self.bottom.init_flax_(generator)
        self.top.init_flax_(generator)
        return self

    def forward(self, dense: torch.Tensor, emb,
                top_weight0: Optional[torch.Tensor] = None,
                mixed_precision: bool = False) -> torch.Tensor:
        """``top_weight0`` replaces the first top layer's weight (or
        ``kernel_q``); ``mixed_precision``: bf16 operands, f32 sums in the
        dense products."""
        if self.bottom_widths[-1] != emb.shape[-1]:
            raise ValueError(
                f"DLRM bottom MLP must end at the embedding dim for the dot "
                f"interaction: bottom_widths[-1]={self.bottom_widths[-1]} vs "
                f"embedding dim {emb.shape[-1]}"
            )
        bottom = self.bottom(dense.float(), mixed_precision=mixed_precision)
        x = self.interaction(bottom, emb)
        return self.top(x, first_weight=top_weight0,
                        mixed_precision=mixed_precision).float().squeeze(-1)


_LAYER = re.compile(r"(Quant)?Dense_(\d+)$")
_DENSE = re.compile(r"Dense_(\d+)$")


def _carry(a) -> torch.Tensor:
    """A Flax array (numpy-readable) -> a CPU tensor with the same bytes.
    fp8 arrives as an ``ml_dtypes`` array, which torch cannot take as such:
    its bytes go across and are viewed as ``float8_e4m3fn``."""
    a = np.asarray(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(np.array(a.view(np.uint8), order="C")).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a, order="C"))


def load_flax_dlrm_params(tree) -> dict:
    """Flax DLRM params (``params/MLP_{0,1}/Dense_i/{kernel,bias}``, or
    ``QuantDense_i/{kernel_q,kernel_scale,bias}`` for a ``quant_fmt``
    model; any array type numpy can read) -> this package's ``DLRM``
    state_dict (``weight = kernel.T``, ``kernel_q`` transposed likewise).
    A module name it does not know raises."""
    params = flax_params(tree)
    state = {}
    for mod, prefix in (("MLP_0", "bottom"), ("MLP_1", "top")):
        layers = params[mod]
        unknown = [k for k in layers if not _LAYER.match(k)]
        if unknown:
            raise ValueError(f"{mod} holds {unknown}: only Dense_i and QuantDense_i "
                             "layers are known")
        for name, layer in layers.items():
            quant, i = _LAYER.match(name).groups()
            key = f"{prefix}.layers.{i}"
            if quant:
                state[f"{key}.kernel_q"] = _carry(np.asarray(layer["kernel_q"]).T)
                state[f"{key}.kernel_scale"] = _carry(np.asarray(layer["kernel_scale"],
                                                                 np.float32))
            else:
                state[f"{key}.weight"] = _carry(np.asarray(layer["kernel"], np.float32).T)
            state[f"{key}.bias"] = _carry(np.asarray(layer["bias"], np.float32))
    return state


# -- Flax trees of the other families (models/*.py) --------------------------


def flax_params(tree) -> dict:
    """The ``params`` collection of a Flax variables tree (or the tree)."""
    return tree["params"] if "params" in tree else tree


def check_known(params, known: Sequence[str], what: str) -> None:
    """Raise on a module or parameter name of ``params`` that is not in
    ``known``."""
    unknown = sorted(set(params) - set(known))
    if unknown:
        raise ValueError(f"{what} holds {unknown}: only {sorted(known)} are known")


def carry_dense(layer, key: str, state: dict) -> None:
    """One Flax ``nn.Dense`` (``kernel`` [in, out], ``bias``) -> ``key.weight``
    ([out, in]) and ``key.bias``. A ``DenseGeneral`` kernel of more axes
    (``[in, *out]``, bias ``[*out]``) is flattened to [in, prod(out)]."""
    k = np.asarray(layer["kernel"], np.float32)
    state[f"{key}.weight"] = _carry(k.reshape(k.shape[0], -1).T)
    state[f"{key}.bias"] = _carry(np.asarray(layer["bias"], np.float32).reshape(-1))


def carry_mlp(layers, prefix: str, state: dict) -> None:
    """A Flax ``MLP`` of ``Dense_i`` layers -> ``prefix.layers.i.{weight,bias}``;
    any other layer name raises."""
    unknown = [k for k in layers if not _DENSE.match(k)]
    if unknown:
        raise ValueError(f"{prefix} holds {unknown}: only Dense_i layers are known")
    for name, layer in layers.items():
        carry_dense(layer, f"{prefix}.layers.{_DENSE.match(name).group(1)}", state)


def carry_param(a, key: str, state: dict) -> None:
    """A bare Flax parameter -> ``key``, as f32."""
    state[key] = _carry(np.asarray(a, np.float32))
