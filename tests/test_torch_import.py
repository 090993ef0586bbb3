"""The PyTorch port stands alone: it loads neither JAX (nor optax) nor the JAX
package, and its entry points refuse to fall back to the CPU unless asked."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "hugectr_backend_tpu_torch"

SLICE_MODULES = [
    "hugectr_backend_tpu_torch",
    "hugectr_backend_tpu_torch.config.params",
    "hugectr_backend_tpu_torch.utils.logging",
    "hugectr_backend_tpu_torch.io.sparse_model",
    "hugectr_backend_tpu_torch.io.synthetic",
    "hugectr_backend_tpu_torch.ops.quantize",
    "hugectr_backend_tpu_torch.ops.kernels",
    "hugectr_backend_tpu_torch.ops.dequant_gather",
    "hugectr_backend_tpu_torch.ops.fused_interaction",
    "hugectr_backend_tpu_torch.tiers.base",
    "hugectr_backend_tpu_torch.tiers.dram",
    "hugectr_backend_tpu_torch.tiers.hbm",
    "hugectr_backend_tpu_torch.serving.metrics",
    "hugectr_backend_tpu_torch.serving.program",
    "hugectr_backend_tpu_torch.cache.lookup_program",
    "hugectr_backend_tpu_torch.cache.embedding_cache",
    "hugectr_backend_tpu_torch.ps.parameter_server",
    "hugectr_backend_tpu_torch.lookup.session",
    "hugectr_backend_tpu_torch.models.dlrm",
    "hugectr_backend_tpu_torch.models.quant_dense",
    "hugectr_backend_tpu_torch.ops.quant_matmul",
    "hugectr_backend_tpu_torch.io.dense_model",
    "hugectr_backend_tpu_torch.eval",
    "hugectr_backend_tpu_torch.eval.auc_parity",
    "hugectr_backend_tpu_torch.ops.onehot_gather",
    "hugectr_backend_tpu_torch.scripts",
    "hugectr_backend_tpu_torch.scripts.common",
    "hugectr_backend_tpu_torch.scripts.microbench_onehot",
    "hugectr_backend_tpu_torch.scripts.microbench_true",
    "hugectr_backend_tpu_torch.scripts.predict_kernels",
    "hugectr_backend_tpu_torch.scripts.k3_phase_split",
    "hugectr_backend_tpu_torch.native.kvstore",
    "hugectr_backend_tpu_torch.utils.timer",
    "hugectr_backend_tpu_torch.utils.tracing",
    "hugectr_backend_tpu_torch.serving.batchpack",
    "hugectr_backend_tpu_torch.serving.scheduler",
    "hugectr_backend_tpu_torch.serving.model_manager",
    "hugectr_backend_tpu_torch.serving.pb_wire",
    "hugectr_backend_tpu_torch.serving.kserve_pb",
    "hugectr_backend_tpu_torch.serving.grpc_server",
    "hugectr_backend_tpu_torch.serving.server",
    "chip_smoke",
]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_import_loads_no_jax_and_no_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'ml_dtypes', 'optax')\n"
        "             or m.startswith(('jax.', 'flax.', 'jaxlib', 'optax.'))\n"
        "             or m == 'hugectr_backend_tpu' or m.startswith('hugectr_backend_tpu.'))\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


_FORBIDDEN = re.compile(
    r"^\s*(?:from|import)\s+(?:jax|flax|ml_dtypes|jaxlib|optax)\b"
    r"|^\s*(?:from|import)\s+hugectr_backend_tpu(?:\.|\s|$)",
    re.MULTILINE,
)


def test_http_front_end_imports_without_grpc():
    """``grpc`` is imported only when a gRPC server is built (the card's
    machine has no grpcio), and importing the front end builds nothing."""
    code = (
        "import sys\n"
        "import hugectr_backend_tpu_torch.serving.server\n"
        "import hugectr_backend_tpu_torch.serving.grpc_server\n"
        "bad = sorted(m for m in sys.modules if m == 'grpc' or m.startswith('grpc.')\n"
        "             or m == 'kserve_v2_pb2')\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_sources_import_no_jax_and_no_jax_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    hits = [(str(f.relative_to(ROOT)), m.group(0).strip())
            for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not hits, hits


def test_parameter_server_needs_a_card_unless_asked_for_cpu(tmp_path):
    from hugectr_backend_tpu_torch import HierParameterServer
    from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    write_sparse_model(tmp_path / "t0", [1, 2, 3], [[1.0], [2.0], [3.0]])
    cfg = {"models": [{
        "model": "m", "sparse_files": [str(tmp_path / "t0")],
        "embedding_vecsize_per_table": [1],
        "maxnum_catfeature_query_per_table_per_sample": [1],
        "embedding_cache_type": "static",
    }]}
    with pytest.raises(RuntimeError, match='device="cpu"'):
        HierParameterServer.create(cfg)
    ps = HierParameterServer.create(cfg, device="cpu")
    assert ps.get_embedding_cache("m", 0).device.type == "cpu"


@pytest.mark.parametrize("option, value", [
    ("embedding_cache_type", "dynamic"),
    ("shard_tables", True),
    ("embedding_cache_type", "uvm"),
])
def test_uncovered_options_raise(tmp_path, option, value):
    from hugectr_backend_tpu_torch import HierParameterServer
    from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model

    write_sparse_model(tmp_path / "t0", [1, 2], [[1.0], [2.0]])
    model = {"model": "m", "sparse_files": [str(tmp_path / "t0")],
             "embedding_vecsize_per_table": [1],
             "maxnum_catfeature_query_per_table_per_sample": [1],
             "embedding_cache_type": "static", "deployed_device_list": [0, 1],
             "gpucacheper": 1.0, option: value}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        HierParameterServer.create({"models": [model]}, device="cpu")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cwd = ROOT
    env = dict(os.environ)
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
        env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("entry", ["train_dlrm", "train_dlrm_multi", "serving_scores",
                                   "multi_serving_scores"])
def test_training_and_harness_need_a_card_unless_asked_for_cpu(tmp_path, entry):
    from hugectr_backend_tpu_torch.eval import auc_parity as tap

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    data = tap.make_click_dataset(64, 20, num_feats=3, seed=0)
    multi = tap.make_multi_click_dataset(64, [5, 9], seed=0)
    model = tap.DLRM(13, 3, (8, 4), (8, 1)).init_flax_(torch.Generator().manual_seed(0))
    table = np.zeros((20, 4), np.float32)
    calls = {
        "train_dlrm": lambda **kw: tap.train_dlrm(data, dim=4, steps=1, batch=8, **kw),
        "train_dlrm_multi": lambda **kw: tap.train_dlrm_multi(multi, dim=4, steps=1, batch=8,
                                                              **kw),
        "serving_scores": lambda **kw: tap.serving_scores(
            model, data.key_ids, table, data.keys_idx[:8], data.dense[:8],
            workdir=str(tmp_path), **kw),
        "multi_serving_scores": lambda **kw: tap.multi_serving_scores(
            tap.DLRM(13, 2, (8, 4), (8, 1)).init_flax_(torch.Generator().manual_seed(0)),
            multi.key_ids, [np.zeros((5, 4), np.float32), np.zeros((9, 4), np.float32)],
            multi.keys_idx[:8], multi.dense[:8], workdir=str(tmp_path), **kw),
    }
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()
    assert np.isfinite(np.asarray(calls[entry](device="cpu")[-1])).all()
