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

A second format, ``hps_tpu_dlrm_v1``, holds a DLRM (MLPerf's dense half:
bottom MLP, dot interaction, top MLP) in the same two files. Only this
package loads it. It is a format of its own, not a ``"model": "dlrm"`` key
under ``hps_tpu_dense_v1``, so that the JAX package refuses it by name: such
a key would pass its format check and fail on the missing ``layers``. Spec
schema (``bottom`` and ``top`` are the MLPs' widths from input to output)::

    {"format": "hps_tpu_dlrm_v1", "num_dense": 13, "num_tables": 26,
     "dim": 128, "bottom": [13, 512, 256, 128],
     "top": [479, 1024, 1024, 512, 256, 1], "interaction": "dot"}

Weights ``bottom.<i>.w`` [in, out], ``bottom.<i>.b``, ``top.<i>.w``,
``top.<i>.b``, loaded into :class:`~hugectr_backend_tpu_torch.models.dlrm.DLRM`
at f32. ``bottom[-1]`` must be ``dim`` and ``top[0]`` ``dim + F(F-1)/2``
(F = ``num_tables`` + 1), ``top[-1]`` 1; a ``quant`` key is refused. The
model takes two named inputs, the dense features (FP32 ``[-1, num_dense]``)
and the embeddings (FP32, flat, table-major as an HPS model's ``OUTPUT0``
gives them: table 0's rows for every sample, then table 1's, ...), in that
order in its ``config.pbtxt``, and gives the logits (FP32 ``[-1, 1]``).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Mapping, Optional, Sequence

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
DENSE_FORMAT = "hps_tpu_dense_v1"
DLRM_FORMAT = "hps_tpu_dlrm_v1"

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

    @property
    def input_names(self) -> tuple:
        return (self.input_name,)

    def set_input_names(self, names: Sequence[str]) -> None:
        """The input names of the model's ``config.pbtxt``: an MLP reads the
        first (as the JAX package does)."""
        self.input_name = str(names[0])

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

    def forward_named(self, inputs: Mapping[str, np.ndarray]) -> np.ndarray:
        """:meth:`forward` on the input of the model's name (KeyError
        without it)."""
        return self.forward(np.asarray(inputs[self.input_name], np.float32))

    # ------------------------------------------------------------ persistence

    @classmethod
    def load(cls, version_dir, name: Optional[str] = None, device=None) -> "DenseModel":
        """Read a model directory onto ``device`` (the card unless
        ``device="cpu"``)."""
        dev = default_device(device)
        vdir = Path(version_dir)
        spec_path = vdir / SPEC_FILE
        spec = _read_spec(vdir)
        if spec.get("format") != DENSE_FORMAT:
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


def _read_spec(vdir: Path) -> dict:
    """A model directory's ``dense_model.json``; a directory without one
    raises, naming a foreign model file it holds."""
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
    return json.loads(spec_path.read_text())


def load_dense_model(version_dir, name: Optional[str] = None, device=None):
    """A model directory of either format: a :class:`DlrmDenseModel` for
    ``hps_tpu_dlrm_v1``, else a :class:`DenseModel`."""
    spec = _read_spec(Path(version_dir))
    cls = DlrmDenseModel if spec.get("format") == DLRM_FORMAT else DenseModel
    return cls.load(version_dir, name, device=device)


def _dlrm_widths(spec: dict, where) -> tuple:
    """-> (num_dense, num_tables, dim, bottom, top) of an ``hps_tpu_dlrm_v1``
    spec; raises ConfigError where they do not make a DLRM."""
    if "quant" in spec:
        raise ConfigError(f"{where}: {DLRM_FORMAT} takes no quant "
                          f"(got {spec['quant']!r}); its layers are f32")
    if spec.get("interaction", "dot") != "dot":
        raise ConfigError(f"{where}: unsupported interaction {spec.get('interaction')!r} "
                          f"(only \"dot\")")
    try:
        nd, nt, dim = (int(spec[k]) for k in ("num_dense", "num_tables", "dim"))
        bottom, top = ([int(w) for w in spec[k]] for k in ("bottom", "top"))
    except (KeyError, TypeError, ValueError) as e:
        raise ConfigError(f"{where}: num_dense, num_tables, dim, bottom and top are "
                          f"required ({e!r})") from None
    if min(nd, nt, dim, *bottom, *top) <= 0 or len(bottom) < 2 or len(top) < 2:
        raise ConfigError(f"{where}: sizes must be positive, bottom and top at least "
                          f"one layer each")
    feats = nt + 1
    want = {"bottom[0]": (bottom[0], nd), "bottom[-1]": (bottom[-1], dim),
            "top[0]": (top[0], dim + feats * (feats - 1) // 2), "top[-1]": (top[-1], 1)}
    for what, (got, need) in want.items():
        if got != need:
            raise ConfigError(f"{where}: {what} is {got}, the DLRM needs {need} "
                              f"(num_dense {nd}, num_tables {nt}, dim {dim})")
    return nd, nt, dim, bottom, top


@dataclasses.dataclass
class DlrmDenseModel:
    """A loaded ``hps_tpu_dlrm_v1`` model (module docstring): ``model`` a
    :class:`~hugectr_backend_tpu_torch.models.dlrm.DLRM` at f32 on the
    model's device. ``input_names``: the dense features', then the
    embeddings'."""

    name: str
    spec: dict
    model: torch.nn.Module
    input_names: tuple = ("dense_features", "embeddings")
    output_name: str = "logits"

    @property
    def num_dense(self) -> int:
        return int(self.spec["num_dense"])

    @property
    def num_tables(self) -> int:
        return int(self.spec["num_tables"])

    @property
    def dim(self) -> int:
        return int(self.spec["dim"])

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def set_input_names(self, names: Sequence[str]) -> None:
        if len(names) != 2:
            raise ConfigError(f"dense model {self.name!r}: a DLRM takes two inputs (the "
                              f"dense features, then the embeddings), config.pbtxt names "
                              f"{list(names)}")
        self.input_names = tuple(str(n) for n in names)

    def metadata(self, name: str) -> dict:
        """KServe-v2 model metadata, served as ``name``."""
        return {
            "name": name, "platform": "hps_tpu_dense",
            "inputs": [{"name": self.input_names[0], "datatype": "FP32",
                        "shape": [-1, self.num_dense]},
                       {"name": self.input_names[1], "datatype": "FP32", "shape": [-1]}],
            "outputs": [{"name": self.output_name, "datatype": "FP32", "shape": [-1, 1]}],
        }

    def config(self, name: str) -> dict:
        """The model configuration, served as ``name``."""
        return {
            "name": name, "platform": "hps_tpu_dense",
            "input": [{"name": self.input_names[0], "data_type": "TYPE_FP32",
                       "dims": [-1, self.num_dense]},
                      {"name": self.input_names[1], "data_type": "TYPE_FP32", "dims": [-1]}],
            "output": [{"name": self.output_name, "data_type": "TYPE_FP32", "dims": [-1, 1]}],
        }

    def apply(self, dense: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """dense [B, num_dense] and the flat table-major embeddings [T * B *
        dim] on the model's device -> logits [B]: the rows viewed as [T, B,
        dim] and handed to the model as [B, T, dim] (K4 reads that view in
        place)."""
        b = dense.shape[0]
        return self.model(dense, emb.reshape(self.num_tables, b, self.dim).transpose(0, 1))

    def forward_named(self, inputs: Mapping[str, np.ndarray]) -> np.ndarray:
        """The logits [B, 1] of one request's named inputs; raises
        RequestError on a missing input or sizes that do not agree."""
        from hugectr_backend_tpu_torch.serving.scheduler import RequestError

        for n in self.input_names:
            if n not in inputs:
                raise RequestError(f"dense model {self.name!r}: input {n!r} is required")
        dense = np.asarray(inputs[self.input_names[0]], np.float32)
        emb = np.asarray(inputs[self.input_names[1]], np.float32)
        b = dense.size // self.num_dense
        if b == 0 or dense.size % self.num_dense or emb.size != self.num_tables * b * self.dim:
            raise RequestError(
                f"dense model {self.name!r}: {dense.size} dense values and {emb.size} "
                f"embedding values are not B x {self.num_dense} and {self.num_tables} x B x "
                f"{self.dim}")
        dev = self.device
        dense_t = torch.from_numpy(np.require(dense.reshape(b, -1), np.float32,
                                              ["C", "W"])).to(dev)
        emb_t = torch.from_numpy(np.require(emb.reshape(-1), np.float32, ["C", "W"])).to(dev)
        with torch.inference_mode():
            return self.apply(dense_t, emb_t).cpu().numpy().reshape(b, 1)

    @classmethod
    def load(cls, version_dir, name: Optional[str] = None, device=None) -> "DlrmDenseModel":
        """Read a model directory onto ``device`` (the card unless
        ``device="cpu"``); a spec or weights that do not make a DLRM raise
        ConfigError here."""
        from hugectr_backend_tpu_torch.models.dlrm import DLRM

        vdir = Path(version_dir)
        spec = _read_spec(vdir)
        where = vdir / SPEC_FILE
        if spec.get("format") != DLRM_FORMAT:
            raise ConfigError(f"{where}: unsupported format {spec.get('format')!r}")
        nd, nt, _dim, bottom, top = _dlrm_widths(spec, where)
        state = {}
        with np.load(vdir / WEIGHTS_FILE) as z:
            for mlp, widths in (("bottom", bottom), ("top", top)):
                for i, (a, b) in enumerate(zip(widths, widths[1:])):
                    w = np.asarray(z[f"{mlp}.{i}.w"], np.float32)
                    bias = np.asarray(z[f"{mlp}.{i}.b"], np.float32)
                    if w.shape != (a, b) or bias.shape != (b,):
                        raise ConfigError(f"{where}: {mlp}.{i} weights {w.shape} / "
                                          f"{bias.shape}, the spec needs ({a}, {b}) / ({b},)")
                    state[f"{mlp}.layers.{i}.weight"] = torch.from_numpy(
                        np.ascontiguousarray(w.T))
                    state[f"{mlp}.layers.{i}.bias"] = torch.from_numpy(bias)
        model = DLRM(nd, nt, bottom[1:], top[1:])
        model.load_state_dict(state)
        return cls(name or vdir.parent.name, spec, model.to(default_device(device)).eval())


def save_dlrm_model(version_dir, num_tables: int, bottom: Sequence, top: Sequence) -> Path:
    """Write ``hps_tpu_dlrm_v1``: ``bottom[i]`` and ``top[i]`` are (w [in, out],
    b [out]) numpy arrays; ``num_dense`` and ``dim`` are the bottom's input
    and output widths. Raises ValueError where they do not make a DLRM."""
    vdir = Path(version_dir)
    widths = {k: [int(np.shape(layers[0][0])[0])] + [int(np.shape(w)[1]) for w, _ in layers]
              for k, layers in (("bottom", bottom), ("top", top))}
    spec = {"format": DLRM_FORMAT, "num_dense": widths["bottom"][0],
            "num_tables": int(num_tables), "dim": widths["bottom"][-1], **widths,
            "interaction": "dot"}
    try:
        _dlrm_widths(spec, vdir)
    except ConfigError as e:
        raise ValueError(str(e)) from None
    vdir.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for k, layers in (("bottom", bottom), ("top", top)):
        for i, (w, b) in enumerate(layers):
            arrays[f"{k}.{i}.w"] = np.asarray(w, np.float32)
            arrays[f"{k}.{i}.b"] = np.asarray(b, np.float32)
    (vdir / SPEC_FILE).write_text(json.dumps(spec, indent=1))
    np.savez(vdir / WEIGHTS_FILE, **arrays)
    return vdir


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
        "format": DENSE_FORMAT,
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
