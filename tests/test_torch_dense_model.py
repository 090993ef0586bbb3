"""The dense-model format (``hps_tpu_dense_v1``) in the PyTorch port against
the JAX package: a directory written by either package loads in the other,
holds the same arrays, and runs to the same outputs.

Tolerances:
- the files: none (the same arrays, bit for bit; fp8 as raw bytes).
- outputs, no quant: rtol 1e-5, atol 1e-6 (f32 matmuls of two libraries,
  which may sum in different orders).
- outputs, weight-only int8/fp8: rtol 1e-3, atol 1e-5. Both sides round the
  dequantized weight and each layer's input to bf16 and sum in f32; an input
  one f32 ulp apart after such a sum can round to a bf16 one step (2^-8)
  apart in the next layer.
- outputs, w8a8: rtol 1e-5, atol 1e-6. The int32 sums are exact on both
  sides, but ``DenseModel.forward`` of the JAX package is jitted, and XLA
  then contracts ``(f32(acc) * xs) * wscale + bias`` into one FMA, so a
  layer's outputs can sit an ulp apart (an ulp apart in a hidden layer could
  move the next layer's quantization by one step; it does not for these
  inputs).
"""

import json

import numpy as np
import pytest
import torch

from hugectr_backend_tpu.io import dense_model as jdm
from hugectr_backend_tpu_torch.io import dense_model as tdm

QUANTS = [None, "int8", "fp8", "w8a8"]
ACTS = ["relu", "relu", "identity"]


def _mlp(seed, dims=(24, 40, 16, 3)):
    rng = np.random.default_rng(seed)
    return [((rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
             (rng.standard_normal(b) * 0.1).astype(np.float32))
            for a, b in zip(dims, dims[1:])]


def _inputs(seed, n=8):
    return np.random.default_rng(seed).standard_normal((n, 2, 12)).astype(np.float32)


def _files(vdir):
    spec = json.loads((vdir / jdm.SPEC_FILE).read_text())
    with np.load(vdir / jdm.WEIGHTS_FILE) as z:
        return spec, {k: z[k] for k in z.files}


def _check(got, want, quant):
    assert got.shape == want.shape and got.dtype == np.float32
    if quant in ("int8", "fp8"):
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("quant", QUANTS, ids=str)
def test_jax_written_model_loads_in_port(tmp_path, quant):
    vdir = jdm.save_dense_model(tmp_path / "m" / "1", _mlp(1), ACTS, reshape=[-1, 24],
                                quant=quant)
    want = jdm.DenseModel.load(vdir).forward(_inputs(2))
    model = tdm.DenseModel.load(vdir, device="cpu")
    assert model.name == "m" and model.input_dim == 24 and model.output_dim == 3
    assert model.weights[0][0].dtype == {None: torch.float32, "int8": torch.int8,
                                         "fp8": torch.float8_e4m3fn,
                                         "w8a8": torch.int8}[quant]
    _check(model.forward(_inputs(2)), want, quant)


@pytest.mark.parametrize("quant", QUANTS, ids=str)
def test_port_written_model_loads_in_jax(tmp_path, quant):
    weights = _mlp(3)
    pdir = tdm.save_dense_model(tmp_path / "p" / "1", weights, ACTS, reshape=[-1, 24],
                                quant=quant)
    jdir = jdm.save_dense_model(tmp_path / "j" / "1", weights, ACTS, reshape=[-1, 24],
                                quant=quant)
    pspec, parrays = _files(pdir)
    jspec, jarrays = _files(jdir)
    assert pspec == jspec
    assert sorted(parrays) == sorted(jarrays)
    for k, v in jarrays.items():
        assert parrays[k].dtype == v.dtype
        np.testing.assert_array_equal(parrays[k], v)
    want = tdm.DenseModel.load(pdir, device="cpu").forward(_inputs(4))
    _check(jdm.DenseModel.load(pdir).forward(_inputs(4)), want, quant)


@pytest.mark.parametrize("quant", [None, "w8a8"], ids=str)
def test_sigmoid_output(tmp_path, quant):
    acts = ["gelu", "tanh", "sigmoid"]
    vdir = jdm.save_dense_model(tmp_path / "m" / "1", _mlp(5), acts, reshape=[-1, 24],
                                quant=quant)
    want = jdm.DenseModel.load(vdir).forward(_inputs(6))
    _check(tdm.DenseModel.load(vdir, device="cpu").forward(_inputs(6)), want, quant)


def test_convert_torch_sequential_matches_jax():
    torch.manual_seed(0)
    seq = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.ReLU(), torch.nn.Linear(5, 4),
                              torch.nn.GELU(), torch.nn.Linear(4, 1), torch.nn.Sigmoid())
    for mod in (seq, torch.jit.trace(seq, torch.zeros(2, 6))):
        tw, ta = tdm.convert_torch_sequential(mod)
        jw, ja = jdm.convert_torch_sequential(mod)
        assert ta == ja == ["relu", "gelu", "sigmoid"]
        for (a, b), (c, d) in zip(tw, jw):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_load_errors(tmp_path):
    from hugectr_backend_tpu_torch.config.params import ConfigError

    (tmp_path / "m").mkdir()
    (tmp_path / "m" / "model.pt").write_bytes(b"")
    with pytest.raises(ConfigError, match="convert"):
        tdm.DenseModel.load(tmp_path / "m", device="cpu")
    vdir = tdm.save_dense_model(tmp_path / "q", _mlp(7), ACTS, quant="int8")
    spec = json.loads((vdir / tdm.SPEC_FILE).read_text())
    spec["quant"] = "int2"
    (vdir / tdm.SPEC_FILE).write_text(json.dumps(spec))
    with pytest.raises(ConfigError, match="int2"):
        tdm.DenseModel.load(vdir, device="cpu")
    with pytest.raises(ValueError, match="activation"):
        tdm.save_dense_model(tmp_path / "r", _mlp(7), ACTS[:2])


def test_w8a8_load_pads_rows_for_k5(tmp_path):
    """Queue C: a w8a8 model with K = 479 keeps each weight [N, K] (its
    ``input_dim`` 479) as the view of rows padded to 16 bytes, and hands K5
    those rows (no second copy), on which ``k5_plan`` picks ``wgmma`` for the
    479 -> 256 layer; the outputs are bit-equal to the plain version on the
    unpadded weights. A second model loaded from other files gives its own
    outputs."""
    from hugectr_backend_tpu_torch.ops.quant_matmul import (
        _wvec,
        k5_plan,
        k5_rows,
        w8a8_dense_plain,
    )

    x = np.random.default_rng(30).standard_normal((16, 479)).astype(np.float32)
    outs = []
    for seed in (31, 32):
        vdir = tdm.save_dense_model(tmp_path / f"m{seed}" / "1",
                                    _mlp(seed, dims=(479, 256, 1)), ["relu", "identity"],
                                    quant="w8a8")
        model = tdm.DenseModel.load(vdir, device="cpu")
        assert model.input_dim == 479 and tuple(model.weights[0][0].shape) == (256, 479)
        k5 = [k5_rows(w) for w, _ in model.weights]
        assert [tuple(w.shape) for w in k5] == [(256, 480), (1, 256)]
        assert [w.data_ptr() for w in k5] == [w.data_ptr() for w, _ in model.weights]
        assert _wvec(k5[0]) and k5_plan(4096, 256, 479, wvec=True).variant == "wgmma"
        unpadded = model.weights[0][0].contiguous()
        assert k5_plan(4096, 256, 479, wvec=_wvec(unpadded)).variant == "narrow"
        want = torch.from_numpy(x)
        for (w, b), s, act in zip(model.weights, model.scales, ["relu", None]):
            want = w8a8_dense_plain(want, w, s, b, act)
        got = model.forward(x)
        np.testing.assert_array_equal(got, want.numpy())
        outs.append(got)
    assert not np.array_equal(*outs)
