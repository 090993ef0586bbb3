"""Triton model-repository compatibility: config.pbtxt parsing + validation.

Port of the JAX package's io/model_repo.py: the same parser, schema checks,
instance-group and parameters rules, repository scan and version switch.
``load_repository(..., device=None)`` loads the dense models onto the card of
the HPS instance that feeds them (``cuda:<id>``), or onto the CPU when the
caller passes ``device="cpu"``.

Lets a user of the reference point this framework at an EXISTING Triton model
repository (the layout ``tritonserver --model-repository=…`` consumes,
reference README.md:105-108) and get the same models served:

    <repo>/
      ps.json                      (the --backend-config=hps,ps=… file)
      <model>/
        config.pbtxt               (Triton model config, protobuf text format)
        1/  2/  …                  (numeric version dirs with sparse files)

Parity targets:
- config.pbtxt schema validation mirrors ``ModelState::ValidateModelConfig``
  (reference model_state.cpp:180-261): exactly two inputs named KEYS
  (TYPE_INT64) and NUMKEYS (TYPE_INT32), dims [-1]; one TYPE_FP32 output with
  dims [-1].
- instance_group rules mirror ``ModelState::ParseModelConfig`` (reference
  model_state.cpp:263-371): KIND_GPU required when the embedding cache is
  enabled (KIND_CPU allowed otherwise), instance count bounded by
  ``num_of_worker_buffer_in_pool``.
- ``parameters { refresh_interval / refresh_delay / freeze_sparse }`` are read
  from config.pbtxt exactly like the reference (model_state.cpp:313-335); the
  ps.json ``max_batch_size`` overrides config.pbtxt's (model_state.cpp:359-366).
- Version dirs: highest numeric subdir wins (Triton "latest" policy); loading
  a repo reports per-model versions so a version bump triggers the online
  redeploy path (reference hps.cc:207-219).

The parser handles the protobuf text-format subset Triton configs use:
``key: value`` scalars, ``key { … }`` nested messages, ``key [ … ]`` repeated
blocks/scalars, comments, and both comma- and newline-separated items.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Any, Mapping, Optional

from hugectr_backend_tpu_torch.config.params import (
    ConfigError,
    InferenceParams,
    ParameterServerConfig,
)
from hugectr_backend_tpu_torch.utils.logging import get_logger

log = get_logger("hps_tpu.model_repo")


# --------------------------------------------------------------------------
# protobuf text-format subset parser
# --------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    \s*(?:
        (?P<comment>\#[^\n]*)
      | (?P<string>"(?:\\.|[^"\\])*")
      | (?P<punct>[{}\[\]:,])
      | (?P<atom>[^\s{}\[\]:,"#]+)
    )
    """,
    re.VERBOSE,
)


def _tokenize(text: str):
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            if text[pos:].strip():
                raise ConfigError(f"config.pbtxt: bad syntax at offset {pos}")
            return
        pos = m.end()
        if m.lastgroup != "comment" and m.group().strip():
            yield m.lastgroup, m.group().strip()


def _atom_value(tok: str) -> Any:
    low = tok.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok  # enum identifier (e.g. TYPE_INT64, KIND_GPU)


class _Tokens:
    def __init__(self, text: str):
        self.toks = list(_tokenize(text))
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        if t[0] is None:
            raise ConfigError("config.pbtxt: unexpected end of file")
        self.i += 1
        return t

    def skip_commas(self):
        while self.peek() == ("punct", ","):
            self.i += 1


def _parse_value(ts: _Tokens) -> Any:
    kind, tok = ts.next()
    if kind == "string":
        return json.loads(tok)  # handles \" escapes
    if kind == "atom":
        return _atom_value(tok)
    if (kind, tok) == ("punct", "{"):
        return _parse_message(ts, stop="}")
    if (kind, tok) == ("punct", "["):
        items = []
        while True:
            ts.skip_commas()
            if ts.peek() == ("punct", "]"):
                ts.next()
                return items
            items.append(_parse_value(ts))


def _parse_message(ts: _Tokens, stop: Optional[str]) -> dict:
    """Parse fields until ``stop`` punct (or EOF). Repeated fields -> list."""
    out: dict[str, Any] = {}
    while True:
        kind, tok = ts.peek()
        if kind is None:
            if stop is None:
                return out
            raise ConfigError(f"config.pbtxt: missing closing {stop!r}")
        if (kind, tok) == ("punct", stop):
            ts.next()
            return out
        if (kind, tok) == ("punct", ","):
            ts.next()
            continue
        if kind not in ("atom", "string"):
            raise ConfigError(f"config.pbtxt: unexpected token {tok!r}")
        ts.next()
        field = tok
        kind2, tok2 = ts.peek()
        if (kind2, tok2) == ("punct", ":"):
            ts.next()
            value = _parse_value(ts)
        elif (kind2, tok2) == ("punct", "{"):
            ts.next()
            value = _parse_message(ts, stop="}")
        elif (kind2, tok2) == ("punct", "["):
            ts.next()
            value = []
            while True:
                ts.skip_commas()
                if ts.peek() == ("punct", "]"):
                    ts.next()
                    break
                value.append(_parse_value(ts))
        else:
            raise ConfigError(f"config.pbtxt: field {field!r} missing value")
        if field in out:
            prev = out[field]
            if not isinstance(prev, list):
                prev = [prev]
            out[field] = prev + (value if isinstance(value, list) else [value])
        else:
            out[field] = value


def parse_pbtxt(text: str) -> dict:
    """Parse protobuf text format (the subset Triton model configs use)."""
    return _parse_message(_Tokens(text), stop=None)


def _as_list(v) -> list:
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


# --------------------------------------------------------------------------
# config.pbtxt validation (ModelState::ValidateModelConfig /ParseModelConfig)
# --------------------------------------------------------------------------

#: config.pbtxt parameters{} the reference reads (model_state.cpp:313-335).
_PBTXT_PARAM_FIELDS = ("refresh_interval", "refresh_delay", "freeze_sparse")


def validate_model_config(cfg: Mapping[str, Any], model_name: str) -> None:
    """Schema checks mirroring reference model_state.cpp:180-261."""
    inputs = _as_list(cfg.get("input"))
    outputs = _as_list(cfg.get("output"))
    if len(inputs) != 2:
        raise ConfigError(
            f"model {model_name!r}: expected 2 inputs (KEYS, NUMKEYS), "
            f"got {len(inputs)} (reference model_state.cpp:191)"
        )
    by_name = {i.get("name"): i for i in inputs}
    if set(by_name) != {"KEYS", "NUMKEYS"}:
        raise ConfigError(
            f"model {model_name!r}: inputs must be named KEYS and NUMKEYS, "
            f"got {sorted(by_name)}"
        )
    if by_name["KEYS"].get("data_type") != "TYPE_INT64":
        raise ConfigError(
            f"model {model_name!r}: input KEYS must be TYPE_INT64 "
            f"(got {by_name['KEYS'].get('data_type')})"
        )
    if by_name["NUMKEYS"].get("data_type") not in ("TYPE_INT32", "TYPE_INT64"):
        raise ConfigError(
            f"model {model_name!r}: input NUMKEYS must be TYPE_INT32"
        )
    if len(outputs) != 1:
        raise ConfigError(
            f"model {model_name!r}: expected exactly 1 output, got {len(outputs)}"
        )
    if outputs[0].get("data_type") != "TYPE_FP32":
        raise ConfigError(
            f"model {model_name!r}: output must be TYPE_FP32 "
            f"(got {outputs[0].get('data_type')})"
        )
    for t in inputs + outputs:
        dims = _as_list(t.get("dims"))
        if dims != [-1]:
            raise ConfigError(
                f"model {model_name!r}: tensor {t.get('name')!r} dims must be "
                f"[-1], got {dims} (variable-length flat tensors)"
            )


def _apply_instance_group(params: InferenceParams, cfg: Mapping[str, Any]) -> None:
    """instance_group rules (reference model_state.cpp:263-371). KIND_GPU
    serves on the listed cards (deployed_devices)."""
    groups = _as_list(cfg.get("instance_group"))
    if not groups:
        return
    count = sum(int(g.get("count", 1)) for g in groups)
    kinds = {g.get("kind", "KIND_AUTO") for g in groups}
    if params.use_gpu_embedding_cache:
        if kinds - {"KIND_GPU", "KIND_AUTO", "KIND_MODEL"}:
            raise ConfigError(
                f"model {params.model_name!r}: instance_group kind must be "
                f"KIND_GPU when the embedding cache is enabled "
                f"(reference model_state.cpp:281-309), got {sorted(kinds)}"
            )
        if count > params.num_of_worker_buffer_in_pool:
            raise ConfigError(
                f"model {params.model_name!r}: {count} instances exceed "
                f"num_of_worker_buffer_in_pool="
                f"{params.num_of_worker_buffer_in_pool} "
                f"(reference model_state.cpp:300-308)"
            )
    gpus = sorted(
        {int(d) for g in groups for d in _as_list(g.get("gpus"))}
    )
    if gpus:
        if params.shard_tables and len(gpus) < 2:
            # Sharded models span ps.json's deployed_device_list as a MESH;
            # a narrower instance_group must not silently shrink it below
            # the sharding minimum (the reference's instance routing is a
            # replica concept, model_state.cpp:281-309).
            raise ConfigError(
                f"model {params.model_name!r}: shard_tables needs >= 2 "
                f"devices, but instance_group names {gpus}; list the mesh "
                "devices in instance_group gpus or drop the override"
            )
        params.deployed_devices = gpus
        # Re-run the cross-field checks the override can invalidate (e.g.
        # num_shards <= len(deployed_device_list): a narrower gpus list
        # would otherwise silently shrink the shard mesh and double
        # per-shard HBM).
        params.validate()


def _apply_pbtxt_params(params: InferenceParams, cfg: Mapping[str, Any]) -> None:
    """parameters{refresh_interval/refresh_delay/freeze_sparse} + batch size
    precedence (reference model_state.cpp:313-366)."""
    raw = _as_list(cfg.get("parameters"))
    kv: dict[str, str] = {}
    for p in raw:
        key = p.get("key")
        val = p.get("value", {})
        if isinstance(val, Mapping):
            val = val.get("string_value", "")
        if key:
            kv[key] = str(val)
    if "refresh_interval" in kv:
        params.refresh_interval = float(kv["refresh_interval"])
    if "refresh_delay" in kv:
        params.refresh_delay = float(kv["refresh_delay"])
    if "freeze_sparse" in kv:
        params.freeze_sparse = kv["freeze_sparse"].strip().lower() in (
            "true", "1", "yes",
        )
    pb_batch = cfg.get("max_batch_size")
    if pb_batch is not None and int(pb_batch) != params.max_batch_size:
        # ps.json wins (reference model_state.cpp:359-366).
        log.warning(
            "model %s: config.pbtxt max_batch_size=%s overridden by ps.json "
            "max_batch_size=%d",
            params.model_name, pb_batch, params.max_batch_size,
        )


# --------------------------------------------------------------------------
# repository scan
# --------------------------------------------------------------------------


@dataclasses.dataclass
class RepoModel:
    name: str
    path: Path
    config: dict
    versions: list[int]  # ascending

    @property
    def latest_version(self) -> int:
        return self.versions[-1]

    def version_dir(self, version: Optional[int] = None) -> Path:
        return self.path / str(version if version is not None else self.latest_version)

    def kind(self, ps_models=()) -> str:
        """Classify: "hps" | "ensemble" | "dense" | "unknown".

        The reference repo serves three kinds of models: the HPS backend
        itself, dense models on other backends (TF/TorchScript/TRT), and
        ensembles composing them (samples/hps-triton-ensemble). Dense foreign
        platforms are recognized so the converted-native check can produce a
        useful error (io/dense_model.py)."""
        from hugectr_backend_tpu_torch.io.dense_model import (
            FOREIGN_DENSE_PLATFORMS,
            SPEC_FILE,
        )

        platform = self.config.get("platform", "")
        backend = self.config.get("backend", "")
        if platform == "ensemble":
            return "ensemble"
        if backend == "hps" or platform == "hps":
            return "hps"
        if (
            platform in FOREIGN_DENSE_PLATFORMS
            or platform == "hps_tpu_dense"
            or (self.version_dir() / SPEC_FILE).exists()
        ):
            return "dense"
        if self.name in ps_models:
            return "hps"
        return "unknown"


def scan_repository(repo_dir) -> dict[str, RepoModel]:
    repo = Path(repo_dir)
    if not repo.is_dir():
        raise ConfigError(f"model repository {repo} does not exist")
    out: dict[str, RepoModel] = {}
    for child in sorted(repo.iterdir()):
        cfg_path = child / "config.pbtxt"
        if not child.is_dir() or not cfg_path.exists():
            continue
        cfg = parse_pbtxt(cfg_path.read_text())
        versions = sorted(
            int(v.name) for v in child.iterdir() if v.is_dir() and v.name.isdigit()
        )
        if not versions:
            raise ConfigError(
                f"model {child.name!r}: no numeric version directories under {child}"
            )
        name = cfg.get("name", child.name)
        if name != child.name:
            raise ConfigError(
                f"model directory {child.name!r} disagrees with config.pbtxt "
                f"name {name!r}"
            )
        out[child.name] = RepoModel(child.name, child, cfg, versions)
    if not out:
        raise ConfigError(f"model repository {repo}: no models found")
    return out


def _resolve_sparse_files(params: InferenceParams, vdir: Path) -> None:
    """Relative sparse_files/dense_file paths resolve against the model's
    version dir (the reference uses absolute paths into the version dir,
    e.g. /model/wdl/1/wdl0_sparse_2000.model). The pre-resolution relative
    paths and the model dir are recorded so a later version bump can
    re-resolve against the NEW version dir
    (:func:`switch_model_version`)."""
    params.repo_model_dir = str(vdir.parent)
    params.repo_rel_sparse_files = list(params.sparse_files)
    resolved = []
    for p in params.sparse_files:
        q = Path(p)
        resolved.append(str(q if q.is_absolute() else vdir / q))
    params.sparse_files = resolved
    if params.dense_file and not Path(params.dense_file).is_absolute():
        params.dense_file = str(vdir / params.dense_file)
    if params.network_file and not Path(params.network_file).is_absolute():
        params.network_file = str(vdir / params.network_file)


def switch_model_version(params: InferenceParams, version: int) -> bool:
    """Re-point a repository model's sparse files at ``<model>/<version>/``.

    Returns True when the switch happened (the params came from a
    repository scan and the version dir exists with every file). Without
    this, a version bump through the load endpoint re-read the OLD
    version's files while reporting the new version number.
    """
    base = getattr(params, "repo_model_dir", None)
    rels = getattr(params, "repo_rel_sparse_files", None)
    if not base or rels is None:
        return False
    vdir = Path(base) / str(int(version))
    if not vdir.is_dir():
        return False
    resolved = []
    for p in rels:
        q = Path(p)
        r = q if q.is_absolute() else vdir / q
        if not q.is_absolute() and not r.exists():
            log.warning(
                "version %s of %s is missing %s; keeping current files",
                version, Path(base).name, q,
            )
            return False
        resolved.append(str(r))
    params.sparse_files = resolved
    return True


@dataclasses.dataclass
class Repository:
    """Everything a Triton-style model repository deploys: HPS sparse models
    (ps.json-configured), native dense models, and ensembles composing them
    (reference samples/hps-triton-ensemble)."""

    ps_config: ParameterServerConfig
    hps_versions: dict[str, int]
    dense: dict          # name -> io.dense_model.DenseModel or DlrmDenseModel
    ensembles: dict      # name -> serving.ensemble.EnsembleSpec


def _dense_device(name: str, ensembles: Mapping, ps_cfg: ParameterServerConfig, device):
    """The device a dense model serves on: the CPU when ``device`` asks for
    it; else the card of the first HPS instance of an ensemble that runs the
    model (so the fused path hands its lookup over without a copy); else
    ``default_device(device)``."""
    from hugectr_backend_tpu_torch.tiers.hbm import default_device

    dev = default_device(device)
    if dev.type == "cpu" or device is not None:
        return dev
    for spec in ensembles.values():
        steps = [s.model_name for s in spec.steps]
        if name in steps:
            for step in steps:
                params = ps_cfg.models.get(step)
                if params is not None:
                    return default_device(f"cuda:{params.instance_devices[0]}")
    return dev


def load_repository(repo_dir, ps_source=None, device=None) -> Repository:
    """Scan a Triton-style model repository and load every model kind.

    ``hps_versions[model]`` is the latest numeric version found (feed it to
    ``ModelManager.load(name, version=…)`` to drive the online-redeploy path
    on bumps). ``device``: None loads the dense models on the card (raises
    with no card), ``"cpu"`` on the CPU; pass the same to
    ``ModelManager.create``.
    """
    from hugectr_backend_tpu_torch.io.dense_model import load_dense_model
    from hugectr_backend_tpu_torch.serving.ensemble import EnsembleSpec

    repo = Path(repo_dir)
    models = scan_repository(repo)
    if ps_source is None:
        ps_source = repo / "ps.json"
        if not ps_source.exists():
            has_hps = any(
                rm.config.get("backend") == "hps" for rm in models.values()
            )
            if has_hps:
                raise ConfigError(
                    f"{ps_source} not found — pass ps_source explicitly "
                    f"(the reference requires --backend-config=hps,ps=…, "
                    f"hps.cc:103-125)"
                )
            ps_source = None
    ps_cfg = (
        ParameterServerConfig.create(ps_source)
        if ps_source is not None
        else ParameterServerConfig(models={})
    )

    versions: dict[str, int] = {}
    dense: dict = {}
    ensembles: dict = {}
    # Ensembles and HPS models first: a dense model's device follows the HPS
    # instance (after instance_group) of the ensemble that runs it.
    kinds = {name: rm.kind(ps_models=set(ps_cfg.models)) for name, rm in models.items()}
    order = {"hps": 0, "ensemble": 1}
    for name, rm in sorted(models.items(), key=lambda nm: order.get(kinds[nm[0]], 2)):
        kind = kinds[name]
        if kind == "hps":
            params = ps_cfg.models.get(name)
            if params is None:
                # The reference warns and skips models absent from ps.json
                # (hps.cc:300-305).
                log.warning(
                    "model %s present in repository but not in ps.json; skipped",
                    name,
                )
                continue
            validate_model_config(rm.config, name)
            _apply_instance_group(params, rm.config)
            _apply_pbtxt_params(params, rm.config)
            _resolve_sparse_files(params, rm.version_dir())
            versions[name] = rm.latest_version
        elif kind == "dense":
            dm = load_dense_model(rm.version_dir(), name,
                                  device=_dense_device(name, ensembles, ps_cfg, device))
            ins = _as_list(rm.config.get("input"))
            outs = _as_list(rm.config.get("output"))
            names = [str(t["name"]) for t in ins if t.get("name")]
            if names:
                dm.set_input_names(names)
            if outs and outs[0].get("name"):
                dm.output_name = str(outs[0]["name"])
            dense[name] = dm
        elif kind == "ensemble":
            ensembles[name] = EnsembleSpec.from_config(name, rm.config)
        else:
            log.warning(
                "model %s: unrecognized platform/backend %r/%r; skipped",
                name, rm.config.get("platform"), rm.config.get("backend"),
            )
    extra = set(ps_cfg.models) - set(models)
    for name in sorted(extra):
        log.info("model %s configured in ps.json without a repository dir", name)
    return Repository(ps_cfg, versions, dense, ensembles)


def load_model_repository(
    repo_dir, ps_source=None, device=None
) -> tuple[ParameterServerConfig, dict[str, int]]:
    """HPS-only view of :func:`load_repository` (kept for the common case of
    a repo holding only HPS models)."""
    bundle = load_repository(repo_dir, ps_source, device=device)
    return bundle.ps_config, bundle.hps_versions
