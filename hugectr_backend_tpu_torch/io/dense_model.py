"""Dense-model format: the dense half of an ensemble, in PyTorch.

Port of the JAX package's io/dense_model.py. The on-disk format is the same,
``hps_tpu_dense_v1``, so a directory written by either package loads in the
other:

    <model>/<version>/dense_model.json   — architecture spec
    <model>/<version>/dense_model.npz    — weights (layers.<i>.w [in,out],
                                           layers.<i>.b [out])

Spec schema::

    {"format": "hps_tpu_dense_v1",
     "reshape": [-1, 416],            # applied to the incoming flat tensor
     "quant": "int8",                 # optional: int8/fp8 weight-only, or w8a8
     "layers": [{"units": 256, "activation": "relu"}, ...]}

With ``quant`` set, weights are stored column-scaled (``layers.<i>.wq``, fp8
as its raw bytes, + ``layers.<i>.wscale``). ``"w8a8"`` runs each layer on K5
with its activation fused in; weight-only ``"int8"``/``"fp8"`` dequantize
the weight in bf16 and multiply with bf16 operands and f32 sums, as the JAX
package does. In memory the port keeps each weight ``[out, in]`` (the
``nn.Linear`` layout, which K5 reads), the transpose of the file's; a w8a8
model keeps each weight in rows zero-padded to 16 bytes (``pad_k16``: an
[out, in] view of them), the layout in which K5 may take its ``wgmma`` plan.

An ensemble (serving/ensemble.py) serves this model behind a lookup; a model
repository (io/model_repo.py) names its input and output tensors
(``input_name`` / ``output_name``). A dense model of a foreign platform
(``FOREIGN_DENSE_PLATFORMS``) is converted to this format, never executed.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from hugectr_backend_tpu_torch.config.params import ConfigError
from hugectr_backend_tpu_torch.models.quant_dense import quantize_weight
from hugectr_backend_tpu_torch.ops.quant_matmul import k5_rows, pad_k16, w8a8_dense
from hugectr_backend_tpu_torch.tiers.hbm import default_device

SPEC_FILE = "dense_model.json"
WEIGHTS_FILE = "dense_model.npz"
QUANTS = (None, "int8", "fp8", "w8a8")

#: Triton platforms the reference's ensembles use for the dense step; these
#: require conversion to the native format (TF/torch/TRT are never executed).
FOREIGN_DENSE_PLATFORMS = (
    "tensorflow_savedmodel",
    "tensorflow_graphdef",
    "pytorch_libtorch",
    "tensorrt_plan",
    "onnxruntime_onnx",
)

_IDENTITY = ("identity", "linear", "none")
_ACTIVATIONS = {
    "relu": F.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    **{name: (lambda x: x) for name in _IDENTITY},
}


def _act_name(layer: dict) -> str:
    return str(layer.get("activation", "identity")).lower()


@dataclasses.dataclass
class DenseModel:
    """A loaded dense model: an MLP over the flattened lookup vectors.

    ``weights[i]`` is (w [out, in], b [out]) on the model's device; with
    ``spec["quant"]`` set, w is int8 or float8_e4m3fn and ``scales[i]`` its
    per-column f32 scales."""

    name: str
    spec: dict
    weights: list
    scales: Optional[list] = None
    # Tensor names from the model's config.pbtxt (the reference's dense demo
    # uses input_1/output_1 — 02_model_inference_hps_tf_ensemble.ipynb).
    input_name: str = "input_1"
    output_name: str = "output_1"

    def __post_init__(self):
        if self.spec.get("quant") == "w8a8":
            self.weights = [(pad_k16(w), b) for w, b in self.weights]
        for layer in self.spec.get("layers", []):
            if _act_name(layer) not in _ACTIVATIONS:
                raise ConfigError(
                    f"dense model {self.name!r}: unknown activation {_act_name(layer)!r} "
                    f"(supported: {sorted(_ACTIVATIONS)})"
                )

    # ------------------------------------------------------------------ shape

    @property
    def reshape(self) -> Optional[list]:
        r = self.spec.get("reshape")
        return [int(d) for d in r] if r is not None else None

    @property
    def input_dim(self) -> int:
        return int(self.weights[0][0].shape[1])

    @property
    def output_dim(self) -> int:
        return int(self.weights[-1][0].shape[0])

    @property
    def device(self) -> torch.device:
        return self.weights[0][0].device

    def metadata(self, name: str) -> dict:
        """KServe-v2 model metadata, served as ``name``."""
        return {
            "name": name, "platform": "hps_tpu_dense",
            "inputs": [{"name": self.input_name, "datatype": "FP32", "shape": [-1]}],
            "outputs": [{"name": self.output_name, "datatype": "FP32",
                         "shape": [-1, self.output_dim]}],
        }

    def config(self, name: str) -> dict:
        """The model configuration, served as ``name``."""
        return {
            "name": name, "platform": "hps_tpu_dense",
            "input": [{"name": self.input_name, "data_type": "TYPE_FP32", "dims": [-1]}],
            "output": [{"name": self.output_name, "data_type": "TYPE_FP32",
                        "dims": [-1, self.output_dim]}],
        }

    # ---------------------------------------------------------------- compute

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """Forward on a tensor: reshape, then the dense layers."""
        if self.reshape is not None:
            x = x.reshape(self.reshape)
        quant = self.spec.get("quant")
        scales = self.scales
        for i, ((w, b), layer) in enumerate(zip(self.weights, self.spec["layers"])):
            act = _act_name(layer)
            if quant == "w8a8":
                x = w8a8_dense(x.float().contiguous(), k5_rows(w), scales[i], b,
                               None if act in _IDENTITY else act)
                continue
            if quant:
                # Weight-only: the dequant multiply rounds to bf16, the
                # product takes bf16 operands (exact in f32), the sums are f32.
                wd = w.to(torch.bfloat16) * scales[i].to(torch.bfloat16)[:, None]
                x = F.linear(x.to(torch.bfloat16).float(), wd.float()) + b
            else:
                x = F.linear(x, w) + b
            x = _ACTIVATIONS[act](x)
        return x

    def forward(self, x: np.ndarray) -> np.ndarray:
        # A read-only buffer (a response's output) is copied, never aliased.
        xt = torch.from_numpy(np.require(x, np.float32, ["C", "W"])).to(self.device)
        with torch.inference_mode():
            return self.apply(xt).cpu().numpy()

    # ------------------------------------------------------------ persistence

    @classmethod
    def load(cls, version_dir, name: Optional[str] = None, device=None) -> "DenseModel":
        """Read a model directory onto ``device`` (the card unless
        ``device="cpu"``)."""
        dev = default_device(device)
        vdir = Path(version_dir)
        spec_path = vdir / SPEC_FILE
        if not spec_path.exists():
            foreign = [
                p.name
                for p in vdir.iterdir()
                if p.name in ("model.savedmodel", "model.pt", "model.plan",
                              "model.onnx", "model.graphdef")
            ] if vdir.is_dir() else []
            hint = (
                f" (found {', '.join(foreign)}: convert it with "
                f"`python tools/convert_dense_model.py`)" if foreign else ""
            )
            raise ConfigError(f"dense model dir {vdir} has no {SPEC_FILE}{hint}")
        spec = json.loads(spec_path.read_text())
        if spec.get("format") != "hps_tpu_dense_v1":
            raise ConfigError(f"{spec_path}: unsupported format {spec.get('format')!r}")
        quant = spec.get("quant")
        if quant not in QUANTS:
            raise ConfigError(f"{spec_path}: unsupported quant {quant!r}")
        with np.load(vdir / WEIGHTS_FILE) as z:
            weights, scales = [], []
            for i in range(len(spec["layers"])):
                if quant:
                    wq = np.ascontiguousarray(z[f"layers.{i}.wq"].T)
                    w = torch.from_numpy(wq)
                    if quant == "fp8":
                        w = w.view(torch.uint8).view(torch.float8_e4m3fn)
                    scales.append(torch.from_numpy(
                        np.asarray(z[f"layers.{i}.wscale"], np.float32)).to(dev))
                else:
                    w = torch.from_numpy(np.ascontiguousarray(
                        np.asarray(z[f"layers.{i}.w"], np.float32).T))
                b = torch.from_numpy(np.asarray(z[f"layers.{i}.b"], np.float32))
                if w.dim() != 2 or tuple(b.shape) != (w.shape[0],):
                    raise ConfigError(
                        f"dense model {vdir}: layer {i} weight shapes "
                        f"{tuple(w.shape[::-1])}/{tuple(b.shape)} inconsistent"
                    )
                weights.append((w.to(dev), b.to(dev)))
        return cls(name or vdir.parent.name, spec, weights,
                   scales=scales if quant else None)


def save_dense_model(
    version_dir,
    weights: Sequence,
    activations: Sequence[str],
    reshape: Optional[Sequence[int]] = None,
    quant: Optional[str] = None,
) -> Path:
    """Write the native dense format. ``weights[i]`` is (w [in,out], b [out])
    as numpy arrays (the file's layout, as in the JAX package).

    ``quant`` ("int8" | "fp8" | "w8a8") stores column-scaled quantized
    kernels; the fp32 weights passed in are quantized here."""
    vdir = Path(version_dir)
    vdir.mkdir(parents=True, exist_ok=True)
    if len(weights) != len(activations):
        raise ValueError("need one activation per layer")
    if quant not in QUANTS:
        raise ValueError(f"unsupported quant {quant!r}")
    spec = {
        "format": "hps_tpu_dense_v1",
        "layers": [
            {"units": int(np.shape(w)[1]), "activation": act}
            for (w, _), act in zip(weights, activations)
        ],
    }
    if reshape is not None:
        spec["reshape"] = [int(d) for d in reshape]
    if quant:
        spec["quant"] = quant
    arrays = {}
    for i, (w, b) in enumerate(weights):
        w = np.asarray(w, dtype=np.float32)
        if quant:
            q, s = quantize_weight(w.T, quant)
            # fp8 rides as raw bytes (npz has no fp8 dtype); load views back.
            q = q.view(torch.uint8) if quant == "fp8" else q
            arrays[f"layers.{i}.wq"] = np.ascontiguousarray(q.numpy().T)
            arrays[f"layers.{i}.wscale"] = s.numpy()
        else:
            arrays[f"layers.{i}.w"] = w
        arrays[f"layers.{i}.b"] = np.asarray(b, dtype=np.float32)
    (vdir / SPEC_FILE).write_text(json.dumps(spec, indent=1))
    np.savez(vdir / WEIGHTS_FILE, **arrays)
    return vdir


def convert_torch_sequential(module):
    """Convert a torch MLP (``nn.Sequential`` of Linear + activation modules,
    or a TorchScript trace of one) to (weights, activations) for
    :func:`save_dense_model`. Torch Linear stores [out,in]; the file keeps
    [in,out], so each weight is transposed."""
    weights: list = []
    activations: list = []
    act_names = {
        "ReLU": "relu", "Sigmoid": "sigmoid", "Tanh": "tanh", "GELU": "gelu",
    }
    for mod in module.modules():
        cls = type(mod).__name__
        if cls == "Linear" or (
            hasattr(mod, "weight") and hasattr(mod, "bias")
            and getattr(mod, "original_name", "") == "Linear"
        ):
            w = mod.weight.detach().cpu().numpy().T
            b = mod.bias.detach().cpu().numpy()
            weights.append((w, b))
            activations.append("identity")
        elif cls in act_names or getattr(mod, "original_name", "") in act_names:
            name = act_names.get(cls) or act_names[mod.original_name]
            if not weights:
                raise ValueError("activation before any Linear layer")
            activations[-1] = name
    if not weights:
        raise ValueError("no Linear layers found in module")
    return weights, activations
