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
    "hugectr_backend_tpu_torch.cache.slotmap",
    "hugectr_backend_tpu_torch.tiers.ssd",
    "hugectr_backend_tpu_torch.update",
    "hugectr_backend_tpu_torch.update.compression",
    "hugectr_backend_tpu_torch.update.record_batch",
    "hugectr_backend_tpu_torch.update.source",
    "hugectr_backend_tpu_torch.update.kafka_lite",
    "hugectr_backend_tpu_torch.update.mini_broker",
    "hugectr_backend_tpu_torch.scripts.tier_query_ab",
    "hugectr_backend_tpu_torch.models",
    "hugectr_backend_tpu_torch.models.wdl",
    "hugectr_backend_tpu_torch.models.dcn",
    "hugectr_backend_tpu_torch.models.deepfm",
    "hugectr_backend_tpu_torch.models.xdeepfm",
    "hugectr_backend_tpu_torch.models.ncf",
    "hugectr_backend_tpu_torch.models.mmoe",
    "hugectr_backend_tpu_torch.models.din",
    "hugectr_backend_tpu_torch.models.bst",
    "hugectr_backend_tpu_torch.models.two_tower",
    "hugectr_backend_tpu_torch.serving.pooled",
    "hugectr_backend_tpu_torch.serving.retrieval",
    "hugectr_backend_tpu_torch.parallel",
    "hugectr_backend_tpu_torch.parallel.mesh",
    "hugectr_backend_tpu_torch.parallel.sharded_table",
    "hugectr_backend_tpu_torch.parallel.sharded_cache",
    "hugectr_backend_tpu_torch.parallel.fused_sharded",
    "hugectr_backend_tpu_torch.entry",
    "hugectr_backend_tpu_torch.io.model_repo",
    "hugectr_backend_tpu_torch.serving.ensemble",
    "hugectr_backend_tpu_torch.tiers.cluster",
    "hugectr_backend_tpu_torch.examples",
    "hugectr_backend_tpu_torch.examples._common",
    "hugectr_backend_tpu_torch.examples.01_deploy_and_lookup",
    "hugectr_backend_tpu_torch.examples.02_fused_dlrm_serving",
    "hugectr_backend_tpu_torch.examples.03_online_updates",
    "hugectr_backend_tpu_torch.examples.04_sharded_multichip",
    "hugectr_backend_tpu_torch.examples.05_triton_repo_ensemble",
    "hugectr_backend_tpu_torch.examples.06_capacity_tiering_int4",
    "hugectr_backend_tpu_torch.examples.07_model_zoo",
    "hugectr_backend_tpu_torch.examples.08_kafka_groups_compression",
    "hugectr_backend_tpu_torch.examples.09_retrieval_topk",
    "hugectr_backend_tpu_torch.tools",
    "hugectr_backend_tpu_torch.tools.convert_dense_model",
    "hugectr_backend_tpu_torch.tools.convert_sparse_model",
    "hugectr_backend_tpu_torch.tools.perf_client",
    "hugectr_backend_tpu_torch.scripts.auc_parity",
    "hugectr_backend_tpu_torch.scripts.frontend_saturation",
    "hugectr_backend_tpu_torch.bench",
    "hugectr_backend_tpu_torch.scripts.microbench_w8a8_kernel",
    "hugectr_backend_tpu_torch.scripts.microbench_dense",
    "hugectr_backend_tpu_torch.scripts.microbench_interaction",
    "hugectr_backend_tpu_torch.scripts.microbench_int4_gather",
    "hugectr_backend_tpu_torch.scripts.microbench_overhead",
    "hugectr_backend_tpu_torch.scripts.microbench_update_storm",
    "hugectr_backend_tpu_torch.scripts.microbench_scaling",
    "hugectr_backend_tpu_torch.scripts.microbench_zoo_dtypes",
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
    ("embedding_cache_type", "stochastic"),
    ("volatile_db", {"type": "redis_cluster", "address": "127.0.0.1:1"}),
])
def test_uncovered_options_raise(tmp_path, option, value):
    """Options the port did not cover raised, naming their ROADMAP item; each
    is covered now and serves: the dynamic, stochastic and UVM caches, the
    ``redis_cluster`` volatile db (here on its local fallback: no node
    answers) and ``shard_tables`` (two shards on the host, one mesh-wide
    instance under device 0)."""
    from hugectr_backend_tpu_torch import HierParameterServer, LookupSession
    from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model

    write_sparse_model(tmp_path / "t0", [1, 2], [[1.0], [2.0]])
    model = {"model": "m", "sparse_files": [str(tmp_path / "t0")],
             "embedding_vecsize_per_table": [1],
             "maxnum_catfeature_query_per_table_per_sample": [1],
             "embedding_cache_type": "static", "deployed_device_list": [0, 1],
             "gpucacheper": 1.0}
    cfg = {"models": [model]}
    if option == "volatile_db":
        cfg[option] = value
    else:
        model[option] = value
    ps = HierParameterServer.create(cfg, device="cpu")
    try:
        if option == "shard_tables":
            with pytest.raises(KeyError):
                ps.get_embedding_cache("m", 1)
        cache = ps.get_embedding_cache("m", 0 if option == "shard_tables" else 1)
        want = {"volatile_db": "EmbeddingCache", "shard_tables": "ShardedEmbeddingCache",
                "embedding_cache_type": "DynamicEmbeddingCache"}[option]
        if value == "uvm":
            want = "UvmEmbeddingCache"
        assert type(cache).__name__ == want
        out = LookupSession.create(ps.get_model_params("m"), cache).lookup_numpy(
            [np.array([2, 7], np.int64)])[0]
        np.testing.assert_array_equal(out, [[2.0], [0.0]])
    finally:
        ps.shutdown()


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


def test_every_example_and_tool_is_checked():
    """Each of the port's examples and tools is in SLICE_MODULES (imported
    without JAX above), and the examples package lists every example."""
    from hugectr_backend_tpu_torch.examples import NAMES

    examples = sorted(p.stem for p in (PKG / "examples").glob("0*.py"))
    assert list(NAMES) == examples and len(examples) == 9
    tools = sorted(p.stem for p in (PKG / "tools").glob("*.py") if p.stem != "__init__")
    assert tools == ["convert_dense_model", "convert_sparse_model", "perf_client"]
    for name in [f"examples.{e}" for e in examples] + [f"tools.{t}" for t in tools]:
        assert f"hugectr_backend_tpu_torch.{name}" in SLICE_MODULES, name


@pytest.mark.parametrize("name", ["01_deploy_and_lookup", "02_fused_dlrm_serving",
                                  "03_online_updates", "05_triton_repo_ensemble",
                                  "06_capacity_tiering_int4", "07_model_zoo",
                                  "09_retrieval_topk"])
def test_examples_need_a_card_unless_asked_for_cpu(tmp_path, name):
    """Every example that puts tensors on a device runs on the card by
    default and raises where there is none (08 runs on the host alone)."""
    from hugectr_backend_tpu_torch.examples import load

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        load(name).main(root=tmp_path)


@pytest.mark.parametrize("name", ["bench", "scripts.microbench_w8a8_kernel",
                                  "scripts.microbench_dense", "scripts.microbench_interaction",
                                  "scripts.microbench_int4_gather",
                                  "scripts.microbench_overhead",
                                  "scripts.microbench_update_storm",
                                  "scripts.microbench_scaling",
                                  "scripts.microbench_zoo_dtypes"])
def test_benchmark_programs_need_a_card_unless_asked_for_cpu(name):
    """The benchmark and each microbenchmark run on the card by default and
    raise where there is none (``--device cpu`` runs them on the CPU)."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    mod = importlib.import_module(f"hugectr_backend_tpu_torch.{name}")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        mod.main([])
