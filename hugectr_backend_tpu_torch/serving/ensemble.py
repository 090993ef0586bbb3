"""Triton-ensemble-compatible DAG serving: sparse lookup + dense forward.

Port of the JAX package's serving/ensemble.py. The reference composes the HPS
backend with a dense backend through a Triton ensemble (``platform:
"ensemble"`` + ``ensemble_scheduling.step[]`` with input_map/output_map —
reference
hps_backend/samples/hps-triton-ensemble/02_model_inference_hps_tf_ensemble.ipynb,
README.md:4-8). Each step there runs in a different engine with a device
round-trip between them.

Here the same config.pbtxt drives two paths:

- **Staged path** (general DAG): steps run in topological order; HPS steps go
  through the :class:`ModelManager` (continuous batcher, metrics, full tier
  cascade), dense steps through ``DenseModel.forward``, with the host
  round-trip between steps that the reference's data flow has (the HPS
  output is table-major and flat).
- **Fused path**: when the DAG is the chain ``hps(single table, full static
  cache) -> dense``, one ``EmbeddingCache.lookup_flat`` (one launch of the
  gather + dequant kernel, K1) feeds ``DenseModel.apply`` on the card (one
  launch of the w8a8 kernel, K5, per layer for a w8a8 model): the lookup
  vectors never reach the host. The batch is padded to the pow2 bucket
  grid; padding slots are the default row and never count as misses.

The fused path is only used when its semantics equal the staged path: a full
(``gpucacheper >= 1``) static cache makes "device miss" == "key absent
everywhere" == default vector (reference docs/architecture.md:32). Unlike
the JAX package, which serves staged when building the fused program raises,
an error of the fused path propagates here; a ragged request still goes
staged, since that is semantics. A ``shard_tables`` HPS model runs the same
chain over its ``ShardedEmbeddingCache.lookup_flat`` (parallel/: one K1
launch per device over every shard), the dense model on the mesh's output
device.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Mapping, Optional

import numpy as np
import torch

from hugectr_backend_tpu_torch.cache.embedding_cache import _bucket
from hugectr_backend_tpu_torch.config.params import ConfigError
from hugectr_backend_tpu_torch.io.dense_model import DenseModel
from hugectr_backend_tpu_torch.serving.scheduler import RequestError
from hugectr_backend_tpu_torch.utils.logging import get_logger

log = get_logger("hps_tpu.ensemble")


def _as_list(v) -> list:
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _map_of(entries) -> dict[str, str]:
    """input_map/output_map pbtxt blocks -> {model_tensor: ensemble_tensor}."""
    out = {}
    for e in _as_list(entries):
        if not isinstance(e, Mapping) or "key" not in e or "value" not in e:
            raise ConfigError(f"bad input_map/output_map entry: {e!r}")
        out[str(e["key"])] = str(e["value"])
    return out


@dataclasses.dataclass
class EnsembleStep:
    model_name: str
    model_version: int
    input_map: dict[str, str]   # model input name -> ensemble tensor name
    output_map: dict[str, str]  # model output name -> ensemble tensor name


@dataclasses.dataclass
class EnsembleSpec:
    """Parsed + topologically sorted ensemble_scheduling config."""

    name: str
    inputs: list[dict]   # [{name, datatype, dims}]
    outputs: list[dict]
    steps: list[EnsembleStep]  # topological order

    @classmethod
    def from_config(cls, name: str, cfg: Mapping) -> "EnsembleSpec":
        if cfg.get("platform") != "ensemble":
            raise ConfigError(f"model {name!r} is not platform: \"ensemble\"")
        sched = cfg.get("ensemble_scheduling") or {}
        raw_steps = _as_list(sched.get("step"))
        if not raw_steps:
            raise ConfigError(
                f"ensemble {name!r}: ensemble_scheduling has no steps"
            )
        steps = [
            EnsembleStep(
                model_name=str(s.get("model_name", "")),
                model_version=int(s.get("model_version", -1)),
                input_map=_map_of(s.get("input_map")),
                output_map=_map_of(s.get("output_map")),
            )
            for s in raw_steps
        ]
        for s in steps:
            if not s.model_name:
                raise ConfigError(f"ensemble {name!r}: step without model_name")
            if not s.output_map:
                raise ConfigError(
                    f"ensemble {name!r}: step {s.model_name} has no output_map"
                )

        def tensor_list(field):
            return [
                {
                    "name": t.get("name"),
                    "datatype": str(t.get("data_type", "TYPE_FP32")).replace(
                        "TYPE_", ""
                    ),
                    "dims": _as_list(t.get("dims")),
                }
                for t in _as_list(cfg.get(field))
            ]

        inputs = tensor_list("input")
        outputs = tensor_list("output")

        # Topological sort: a step is runnable once every ensemble tensor its
        # input_map references has been produced (Triton schedules the same
        # way from the dependency graph).
        available = {i["name"] for i in inputs}
        ordered: list[EnsembleStep] = []
        pending = list(steps)
        while pending:
            runnable = [
                s for s in pending
                if set(s.input_map.values()) <= available
            ]
            if not runnable:
                missing = {
                    t for s in pending for t in s.input_map.values()
                } - available
                raise ConfigError(
                    f"ensemble {name!r}: steps "
                    f"{[s.model_name for s in pending]} are unreachable — "
                    f"tensors {sorted(missing)} are never produced "
                    f"(cycle or missing input)"
                )
            for s in runnable:
                ordered.append(s)
                pending.remove(s)
                available |= set(s.output_map.values())
        for o in outputs:
            if o["name"] not in available:
                raise ConfigError(
                    f"ensemble {name!r}: output {o['name']!r} is never produced"
                )
        return cls(name, inputs, outputs, ordered)


@dataclasses.dataclass(frozen=True)
class _FusedChain:
    """What the fused path needs, fixed when it is built."""

    device_id: int
    sharded: bool   # the HPS model's tables are row-sharded over a mesh
    k: int          # keys a sample
    rows_per_sample: int  # dense output rows a sample
    max_batch_size: int
    sparse: EnsembleStep
    dense: EnsembleStep


class EnsembleServer:
    """Executes one ensemble against the live ModelManager + dense models.

    Thread-safe: the fused build is locked; execution is stateless apart from
    the shared cache/batcher objects, which are themselves safe.
    """

    def __init__(self, spec: EnsembleSpec, manager, dense_models: Mapping[str, DenseModel]):
        self.spec = spec
        self.manager = manager
        self.dense = dict(dense_models)
        self._lock = threading.Lock()
        self._fused: Optional[_FusedChain] = None  # built lazily
        # Set once a build has decided (built or declined); a build that
        # raises leaves it unset, so every later infer raises again.
        self._fused_ready = False
        for s in spec.steps:
            if s.model_name not in self.dense and not self._is_hps(s.model_name):
                log.warning(
                    "ensemble %s: step model %r is neither an HPS model nor a "
                    "dense model (will fail at infer time)",
                    spec.name, s.model_name,
                )

    def _is_hps(self, model_name: str) -> bool:
        try:
            self.manager.ps.get_model_params(model_name)
            return True
        except (KeyError, ConfigError):
            return False

    # ------------------------------------------------------- front-end views

    def ready(self) -> bool:
        """Ready when every HPS step of the DAG is loaded."""
        return all(self.manager.is_loaded(s.model_name) for s in self.spec.steps
                   if s.model_name not in self.dense)

    def metadata(self, name: str) -> dict:
        """KServe-v2 model metadata, served as ``name``."""
        spec = self.spec
        return {
            "name": name, "platform": "ensemble",
            "inputs": [{"name": t["name"], "datatype": t["datatype"], "shape": t["dims"]}
                       for t in spec.inputs],
            "outputs": [{"name": t["name"], "datatype": t["datatype"], "shape": t["dims"]}
                        for t in spec.outputs],
            "steps": [s.model_name for s in spec.steps],
        }

    def config(self, name: str) -> dict:
        """The model configuration (the config.pbtxt content), served as ``name``."""
        spec = self.spec
        return {
            "name": name, "platform": "ensemble",
            "input": spec.inputs, "output": spec.outputs,
            "ensemble_scheduling": {"step": [
                {"model_name": s.model_name, "model_version": s.model_version,
                 "input_map": s.input_map, "output_map": s.output_map}
                for s in spec.steps
            ]},
        }

    # --------------------------------------------------------------- fused

    def _build_fused(self) -> Optional[_FusedChain]:
        """-> the fused chain when the hps->dense chain may run fused (see
        the module docstring); None when its semantics would differ from the
        staged path's."""
        s = self.spec.steps
        if len(s) != 2:
            return None
        sparse, dense_step = s
        if not self._is_hps(sparse.model_name):
            return None
        dm = self.dense.get(dense_step.model_name)
        if dm is None:
            return None
        # The sparse output must be the dense step's only input.
        link = set(sparse.output_map.values())
        if set(dense_step.input_map.values()) != link or len(link) != 1:
            return None
        params = self.manager.ps.get_model_params(sparse.model_name)
        cache_type = getattr(
            params.embedding_cache_type, "value", params.embedding_cache_type
        )
        if (
            params.num_tables != 1
            or str(cache_type) != "static"
            or params.cache_size_percentage < 1.0
        ):
            return None
        rs = dm.reshape
        k = params.maxnum_catfeature_query_per_table_per_sample[0]
        d = params.embedding_vecsize_per_table[0]
        if rs is None or len(rs) != 2 or rs[0] != -1 or rs[1] <= 0 or (k * d) % rs[1]:
            return None  # padding would not stay a clean row prefix
        log.info(
            "ensemble %s: fused %s%s -> %s (one lookup launch per device feeds "
            "the dense model on the device)", self.spec.name,
            "sharded " if params.shard_tables else "", sparse.model_name,
            dense_step.model_name,
        )
        return _FusedChain(
            params.instance_devices[0], bool(params.shard_tables), k, (k * d) // rs[1],
            params.max_batch_size, sparse, dense_step)

    def _run_fused(self, tensors: dict[str, np.ndarray]) -> Optional[dict]:
        fc = self._fused
        # Fetch the LIVE cache every call: unload destroys it and a reload
        # creates a new object — a cache captured at build time would keep
        # serving the previous version's embeddings forever.
        try:
            cache = self.manager.ps.get_embedding_cache(fc.sparse.model_name, fc.device_id)
        except KeyError:
            return None  # not loaded: the staged path raises the real error
        keys_name = fc.sparse.input_map.get("KEYS")
        num_name = fc.sparse.input_map.get("NUMKEYS")
        if keys_name not in tensors or num_name not in tensors:
            return None
        keys = np.asarray(tensors[keys_name], dtype=np.int64).reshape(-1)
        numkeys = np.asarray(tensors[num_name], dtype=np.int64).reshape(-1)
        k = fc.k
        if keys.size % k or numkeys.size != 1 or int(numkeys[0]) != keys.size:
            return None  # ragged request: the staged path handles it
        b = keys.size // k
        if b == 0:
            raise RequestError(f"ensemble {self.spec.name}: empty request")
        if b > fc.max_batch_size:
            raise RequestError(
                f"ensemble {self.spec.name}: {b} samples exceed max batch size "
                f"{fc.max_batch_size} (reference hps.cc:573-582)"
            )
        dm = self.dense[fc.dense.model_name]
        # One K1 launch (per device of a sharded model's mesh) over b_pad * k
        # slots; the hit meter counts the b * k real keys, the pad rows are
        # default rows.
        flat = cache.lookup_flat([keys], pad_counts=[_bucket(b) * k])
        with torch.inference_mode():
            y = dm.apply(flat.to(dm.device))
        out = y[: b * fc.rows_per_sample].cpu().numpy()
        out_name = next(iter(fc.dense.output_map.values()))
        return {out_name: out}

    # --------------------------------------------------------------- execute

    def infer(self, named_inputs: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Run the DAG. Input/output names are the ensemble's declared ones."""
        tensors: dict[str, np.ndarray] = {}
        declared = {i["name"] for i in self.spec.inputs}
        for name in declared:
            if name not in named_inputs:
                raise RequestError(
                    f"ensemble {self.spec.name}: missing input {name!r} "
                    f"(declared inputs: {sorted(declared)})"
                )
            tensors[name] = np.asarray(named_inputs[name])

        if not self._fused_ready:
            with self._lock:
                if not self._fused_ready:
                    self._fused = self._build_fused()
                    self._fused_ready = True
        if self._fused is not None:
            result = self._run_fused(tensors)
            if result is not None:
                tensors.update(result)
                return self._collect_outputs(tensors)

        return self.infer_staged(tensors)

    def infer_staged(self, tensors: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Step-by-step execution (always valid; used for ragged requests and
        non-canonical DAGs, and as the fused path's equivalence oracle)."""
        tensors = dict(tensors)
        for step in self.spec.steps:
            if self._is_hps(step.model_name):
                keys_t = step.input_map.get("KEYS")
                num_t = step.input_map.get("NUMKEYS")
                if keys_t is None or num_t is None:
                    raise RequestError(
                        f"ensemble {self.spec.name}: HPS step "
                        f"{step.model_name!r} must map KEYS and NUMKEYS"
                    )
                resp = self.manager.infer(
                    step.model_name,
                    np.asarray(tensors[keys_t], np.int64).reshape(-1),
                    np.asarray(tensors[num_t], np.int64).reshape(-1),
                )
                out_name = step.output_map.get("OUTPUT0")
                if out_name is None:
                    raise RequestError(
                        f"ensemble {self.spec.name}: HPS step "
                        f"{step.model_name!r} must map OUTPUT0"
                    )
                tensors[out_name] = np.asarray(resp.output, np.float32)
            elif step.model_name in self.dense:
                dm = self.dense[step.model_name]
                if len(step.input_map) != 1:
                    raise RequestError(
                        f"ensemble {self.spec.name}: dense step "
                        f"{step.model_name!r} takes exactly one input"
                    )
                (src,) = step.input_map.values()
                y = dm.forward(np.asarray(tensors[src], np.float32))
                (dst,) = step.output_map.values()
                tensors[dst] = y
            else:
                raise RequestError(
                    f"ensemble {self.spec.name}: step model "
                    f"{step.model_name!r} is not loaded"
                )
        return self._collect_outputs(tensors)

    def _collect_outputs(self, tensors) -> dict[str, np.ndarray]:
        return {o["name"]: np.asarray(tensors[o["name"]]) for o in self.spec.outputs}
