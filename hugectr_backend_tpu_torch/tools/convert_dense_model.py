"""Convert a torch dense model to the native dense-model format.

The reference's ensembles run the dense half on a foreign backend —
TorchScript (``model.pt``), TF SavedModel, or a TensorRT plan (reference
hps_backend/samples/hps-triton-ensemble/HPS_Pytorch_ensemble_deployment.ipynb
writes ``platform: "pytorch_libtorch"`` with a traced MLP). Both packages of
this repo run the dense half themselves so that it chains with the embedding
gather; this tool converts a torch MLP into their shared format at deploy
time:

    python -m hugectr_backend_tpu_torch.tools.convert_dense_model <model.pt> \\
        <version_dir> [--reshape -1 416] [--quant int8|fp8|w8a8] [--device cpu]

``model.pt`` may be a TorchScript archive (``torch.jit.save``) or a pickled
``nn.Module``. Supported layers: Linear + ReLU/Sigmoid/Tanh/GELU (the MLP
shapes the reference's recsys dense networks use). The result is
``dense_model.json`` + ``dense_model.npz`` in <version_dir>, loadable by
``hugectr_backend_tpu_torch.io.dense_model.DenseModel`` and by the JAX
package's; the arrays and the JSON are those the JAX package's tool writes.

Then the written model is loaded back on ``--device`` (the card unless
``--device cpu``; raises with no card) and run on 64 seeded rows beside the
torch module: an f32 model must agree within rtol 1e-5 / atol 1e-6 (f32 sums
in another order), a quantized one prints its largest difference.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

CHECK_ROWS = 64
CHECK_TOL = (1e-5, 1e-6)  # rtol, atol of an f32 model against the torch module


def check_on_device(module, version_dir, device) -> float:
    """Load ``version_dir`` on ``device``, run it and ``module`` (on the
    CPU) on CHECK_ROWS seeded rows; -> max |delta|. Raises for an f32 model
    outside CHECK_TOL."""
    import torch

    from hugectr_backend_tpu_torch.io.dense_model import DenseModel
    from hugectr_backend_tpu_torch.tiers.hbm import default_device

    dm = DenseModel.load(version_dir, device=default_device(device))
    x = np.random.default_rng(0).standard_normal(
        (CHECK_ROWS, dm.input_dim)).astype(np.float32)
    got = dm.forward(x)
    with torch.no_grad():
        want = module(torch.from_numpy(x)).numpy().reshape(got.shape)
    err = float(np.abs(got - want).max())
    if dm.spec.get("quant") is None and not np.allclose(got, want, rtol=CHECK_TOL[0],
                                                        atol=CHECK_TOL[1]):
        raise SystemExit(f"{version_dir}: the converted model differs from the torch "
                         f"module by up to {err} on {dm.device}")
    return err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("model_pt", help="TorchScript archive or pickled nn.Module")
    ap.add_argument("version_dir", help="Triton model version dir to write into")
    ap.add_argument(
        "--reshape", type=int, nargs="+", default=None,
        help="reshape applied to the incoming flat tensor, e.g. --reshape -1 416",
    )
    ap.add_argument(
        "--quant", choices=("int8", "fp8", "w8a8"), default=None,
        help="store column-scaled quantized kernels: int8/fp8 weight-only "
        "(dequantized to bf16 for the product) or w8a8 (activations quantized "
        "at serve time, int8 products on the card's tensor cores)",
    )
    ap.add_argument("--device", default=None,
                    help="where the written model is checked: the card unless 'cpu'")
    args = ap.parse_args(argv)

    import torch

    from hugectr_backend_tpu_torch.io.dense_model import (
        convert_torch_sequential,
        save_dense_model,
    )

    path = Path(args.model_pt)
    try:
        module = torch.jit.load(str(path), map_location="cpu")
    except RuntimeError:
        module = torch.load(str(path), map_location="cpu", weights_only=False)
    weights, activations = convert_torch_sequential(module)
    out = save_dense_model(args.version_dir, weights, activations,
                           args.reshape, quant=args.quant)
    dims = " -> ".join(
        [str(weights[0][0].shape[0])] + [str(w.shape[1]) for w, _ in weights]
    )
    print(f"wrote {out}/dense_model.json (+.npz): MLP {dims}, "
          f"activations {activations}"
          + (f", {args.quant} weight-only kernels" if args.quant else ""))
    err = check_on_device(module, out, args.device)
    print(f"checked on {args.device or 'cuda'}: max |delta| {err:.3g} against the "
          f"torch module on {CHECK_ROWS} rows")
    return 0


if __name__ == "__main__":
    sys.exit(main())
