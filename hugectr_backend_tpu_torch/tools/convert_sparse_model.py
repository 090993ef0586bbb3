"""Convert trained embedding tables to the HPS sparse-model binary format.

The reference's training notebook ships a ``convert_to_sparse_model`` helper
(reference samples/hps-triton-ensemble/01_model_training.ipynb: struct.pack
'q' keys + 'Nf' vectors per table dir); this is the standalone CLI for the
same trainer -> deployment hand-off, accepting:

- a ``.npz`` with arrays ``keys_<name>`` / ``vectors_<name>`` (or a single
  ``keys``/``vectors`` pair),
- a torch checkpoint (``.pt``/``.pth``): every 2-D float tensor whose name
  contains "embedding" becomes one table with keys 0..N-1 (bucketized
  Criteo-style tables), or pass ``--tensor NAME`` to pick specific ones.

Output: one table dir per table (``<out>/<table>/key`` + ``emb_vector``),
loadable via ps.json ``sparse_files`` (io/sparse_model.py reader; format per
reference docs/architecture.md:185-218). The files are the JAX package's
tool's, byte for byte. A host tool: it reads and writes files and touches no
device.

    python -m hugectr_backend_tpu_torch.tools.convert_sparse_model ckpt.pt /models/dlrm/1/
    python -m hugectr_backend_tpu_torch.tools.convert_sparse_model tables.npz out/ \\
        --prefix sparse_emb
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model


def _tables_from_npz(path):
    data = np.load(path)
    names = sorted(
        k[len("keys_"):] for k in data.files if k.startswith("keys_"))
    if names:
        for n in names:
            vk = f"vectors_{n}"
            if vk not in data.files:
                raise SystemExit(f"{path}: missing {vk} for keys_{n}")
            yield n, np.asarray(data[f"keys_{n}"]), np.asarray(data[vk])
        return
    if "keys" in data.files and "vectors" in data.files:
        yield "table0", np.asarray(data["keys"]), np.asarray(data["vectors"])
        return
    raise SystemExit(
        f"{path}: expected keys/vectors or keys_<name>/vectors_<name> arrays,"
        f" found {data.files}")


def _tables_from_torch(path, tensor_names):
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    state = obj.state_dict() if hasattr(obj, "state_dict") else obj
    if not isinstance(state, dict):
        raise SystemExit(f"{path}: not a state dict or module checkpoint")
    picked = []
    for name, t in state.items():
        if not hasattr(t, "ndim") or t.ndim != 2:
            continue
        if tensor_names:
            if name in tensor_names:
                picked.append((name, t))
        elif "embedding" in name.lower():
            picked.append((name, t))
    if not picked:
        what = ("names " + ",".join(tensor_names) if tensor_names
                else 'substring "embedding"')
        raise SystemExit(f"{path}: no 2-D embedding tensors matched ({what})")
    for name, t in picked:
        vec = t.detach().float().numpy()
        keys = np.arange(vec.shape[0], dtype=np.int64)
        yield name.replace(".", "_"), keys, vec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint", help=".npz | torch .pt/.pth")
    ap.add_argument("out_dir", help="output root (one subdir per table)")
    ap.add_argument("--tensor", action="append", default=[],
                    help="torch tensor name(s) to export (repeatable)")
    ap.add_argument("--prefix", default="",
                    help="prefix for output table dir names")
    args = ap.parse_args(argv)

    src = pathlib.Path(args.checkpoint)
    out = pathlib.Path(args.out_dir)
    gen = (_tables_from_npz(src) if src.suffix == ".npz"
           else _tables_from_torch(src, args.tensor))
    n = 0
    for name, keys, vectors in gen:
        d = out / f"{args.prefix}{name}"
        write_sparse_model(d, keys, vectors)
        print(f"wrote {d}: {keys.shape[0]} keys x {vectors.shape[1]} dim")
        n += 1
    print(f"converted {n} table(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
