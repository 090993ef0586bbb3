"""``tools.convert_dense_model`` against the JAX package's tool: each run as
a subprocess on the same model, the outputs compared.

Tolerances: the files are bit-identical (the JSON byte for byte and every
array of the .npz, dtype, shape and bytes). A model converted by either tool
loads in both packages, and their f32 forwards agree within rtol 1e-5 /
atol 1e-6 (sums in another order); the quantized formats dequantize the
same bytes (their products are held in tests/test_torch_dense_model.py).
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


# -------------------------------------------------------------------- dense


def _mlp(seed: int):
    g = torch.Generator().manual_seed(seed)
    mlp = torch.nn.Sequential(torch.nn.Linear(24, 16), torch.nn.ReLU(),
                              torch.nn.Linear(16, 8), torch.nn.Tanh(),
                              torch.nn.Linear(8, 1), torch.nn.Sigmoid())
    with torch.no_grad():
        for p in mlp.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    return mlp


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("fmt, quant", [("torchscript", None), ("pickled", "int8"),
                                         ("torchscript", "fp8"), ("pickled", "w8a8")])
def test_convert_dense_model_matches_jax_tool(tmp_path, fmt, quant):
    from hugectr_backend_tpu.io.dense_model import DenseModel as JaxDenseModel
    from hugectr_backend_tpu_torch.io.dense_model import DenseModel

    mlp = _mlp(3).eval()
    src = tmp_path / "model.pt"
    if fmt == "torchscript":
        torch.jit.save(torch.jit.script(mlp), str(src))
    else:
        torch.save(mlp, str(src))
    flags = ["--reshape", "-1", "24"] + (["--quant", quant] if quant else [])
    jout = _run(["tools/convert_dense_model.py", str(src), str(tmp_path / "jax"), *flags])
    tout = _run(["-m", "hugectr_backend_tpu_torch.tools.convert_dense_model", str(src),
                 str(tmp_path / "torch"), *flags, "--device", "cpu"])
    assert tout.splitlines()[0].replace("torch", "OUT") == jout.strip().replace("jax", "OUT")
    assert "checked on cpu" in tout
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    assert (tdir / "dense_model.json").read_bytes() == (jdir / "dense_model.json").read_bytes()
    want, got = _npz(jdir / "dense_model.npz"), _npz(tdir / "dense_model.npz")
    assert got.keys() == want.keys()
    for k in want:
        assert (got[k].dtype, got[k].shape) == (want[k].dtype, want[k].shape), k
        assert got[k].tobytes() == want[k].tobytes(), k
    # Each package loads the other's file.
    x = np.random.default_rng(0).standard_normal((16, 24)).astype(np.float32)
    a = DenseModel.load(jdir, device="cpu").forward(x)
    b = np.asarray(JaxDenseModel.load(tdir).forward(x))
    assert a.shape == b.shape == (16, 1)
    if quant is None:
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        with torch.no_grad():
            np.testing.assert_allclose(a, mlp(torch.from_numpy(x)).numpy(), rtol=1e-5,
                                       atol=1e-6)
    else:
        assert np.isfinite(a).all() and np.isfinite(b).all()


def test_convert_dense_model_checks_on_a_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is the card")
    src = tmp_path / "model.pt"
    torch.save(_mlp(1), str(src))
    r = subprocess.run([sys.executable, "-m",
                        "hugectr_backend_tpu_torch.tools.convert_dense_model", str(src),
                        str(tmp_path / "out")], cwd=ROOT, env=tool_env(), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and 'device="cpu"' in r.stderr


def test_convert_dense_model_check_catches_a_wrong_file(tmp_path, monkeypatch):
    """The check holds the written file to the module: a file whose weights
    differ from the module's fails it."""
    from hugectr_backend_tpu_torch.io.dense_model import convert_torch_sequential, save_dense_model
    from hugectr_backend_tpu_torch.tools import convert_dense_model as tool

    mlp = _mlp(2)
    weights, acts = convert_torch_sequential(mlp)
    weights[1] = (weights[1][0] * 1.01, weights[1][1])
    save_dense_model(tmp_path, weights, acts)
    with pytest.raises(SystemExit, match="differs from the torch module"):
        tool.check_on_device(mlp, tmp_path, "cpu")
    save_dense_model(tmp_path, *convert_torch_sequential(mlp))
    assert tool.check_on_device(mlp, tmp_path, "cpu") <= 1e-5
