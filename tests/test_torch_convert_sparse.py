"""``tools.convert_sparse_model`` against the JAX package's tool: each run
as a subprocess on the same inputs, the written tables compared byte for
byte (tests/test_torch_convert_dense.py does the dense converter).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_examples_common import tool_env
from torch_examples_common import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parent.parent


def _run(args):
    r = subprocess.run([sys.executable, *args], cwd=ROOT, env=tool_env(), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def _tree_bytes(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


# ------------------------------------------------------------------- sparse


def _sparse_inputs(tmp_path, kind):
    rng = np.random.default_rng(7)
    if kind == "npz_named":
        src = tmp_path / "tables.npz"
        np.savez(src, keys_user=rng.choice(10_000, 300, replace=False),
                 vectors_user=rng.standard_normal((300, 16)).astype(np.float32),
                 keys_item=np.arange(50, dtype=np.int64),
                 vectors_item=rng.standard_normal((50, 8)).astype(np.float64))
        return src, ["--prefix", "sparse_"]
    if kind == "npz_pair":
        src = tmp_path / "pair.npz"
        np.savez(src, keys=np.arange(20, dtype=np.int64) * 3,
                 vectors=rng.standard_normal((20, 4)).astype(np.float32))
        return src, []
    src = tmp_path / "ckpt.pt"
    state = {"emb.embedding_0.weight": torch.randn(40, 8, generator=torch.Generator()
                                                   .manual_seed(1)),
             "mlp.0.weight": torch.randn(8, 8),
             "other_table": torch.randn(12, 4, dtype=torch.float64)}
    torch.save(state, src)
    return src, (["--tensor", "other_table"] if kind == "torch_named" else [])


@pytest.mark.parametrize("kind", ["npz_named", "npz_pair", "torch_embedding", "torch_named"])
def test_convert_sparse_model_matches_jax_tool(tmp_path, kind):
    src, flags = _sparse_inputs(tmp_path, kind)
    jout = _run(["tools/convert_sparse_model.py", str(src), str(tmp_path / "jax"), *flags])
    tout = _run(["-m", "hugectr_backend_tpu_torch.tools.convert_sparse_model", str(src),
                 str(tmp_path / "torch"), *flags])
    want, got = _tree_bytes(tmp_path / "jax"), _tree_bytes(tmp_path / "torch")
    assert got and got.keys() == want.keys()
    for name in want:
        assert got[name] == want[name], name
    assert tout.replace(str(tmp_path / "torch"), "OUT") == jout.replace(
        str(tmp_path / "jax"), "OUT")


def test_convert_sparse_model_refuses_what_the_jax_tool_refuses(tmp_path):
    src = tmp_path / "bad.npz"
    np.savez(src, keys_a=np.arange(3))
    for args in (["tools/convert_sparse_model.py"],
                 ["-m", "hugectr_backend_tpu_torch.tools.convert_sparse_model"]):
        r = subprocess.run([sys.executable, *args, str(src), str(tmp_path / "o")], cwd=ROOT,
                           env=tool_env(), capture_output=True, text=True, timeout=300)
        assert r.returncode != 0 and "missing vectors_a for keys_a" in r.stderr
