#!/bin/bash
# The port's CI pass: its tests, every example, the entry points, the load
# generator against a server, and the smoke passes of bench, auc_parity and
# frontend_saturation, all on one device.
#
#   hugectr_backend_tpu_torch/scripts/ci.sh [cpu|cuda]    (default: cpu)
#
# "cpu" runs everything on the host (the kernels' plain versions); "cuda"
# runs on the card (the kernels; needs nvcc to build them at first use).
# The tests run on the CPU either way: they hold the port against the JAX
# package.
set -euo pipefail
cd "$(dirname "$0")/../.."
DEVICE="${1:-cpu}"
case "$DEVICE" in
  cpu|cuda) ;;
  *) echo "usage: $0 [cpu|cuda]" >&2; exit 2 ;;
esac
if [ "$DEVICE" = cuda ]; then DEV=cuda:0; else DEV=cpu; fi
PKG=hugectr_backend_tpu_torch

echo "== tests (the port against the JAX package, on the CPU)"
if python -c "import jax, flax" 2> /dev/null; then
  JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py -q
else
  # The tests hold the port against the JAX package; a machine without JAX
  # (the card's) cannot run them, and says so.
  echo "-- NOT RUN: jax / flax are not installed on this machine"
fi

echo "== examples (--device $DEV)"
for e in $(python -c "from $PKG.examples import NAMES; print(' '.join(NAMES))"); do
  echo "-- $e"
  python -m "$PKG.examples.$e" --device "$DEV" > /dev/null
done

echo "== entry() and dryrun_multichip(8) on $DEV"
python - "$DEV" <<'PY'
import sys
import torch
from hugectr_backend_tpu_torch.entry import dryrun_multichip, entry
fn, args = entry(device=sys.argv[1])
logits = fn(*args)
assert logits.shape == (128,) and bool(torch.isfinite(logits).all()), logits
print("entry ok:", dryrun_multichip(8, device=sys.argv[1]))
PY

echo "== perf_client against a server on $DEV"
ROOT=$(mktemp -d)
SERVER=
trap '[ -n "$SERVER" ] && kill "$SERVER" 2>/dev/null; rm -rf "$ROOT"' EXIT
python - "$ROOT" <<'PY'
import json, sys
from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
from hugectr_backend_tpu_torch.io.synthetic import make_synthetic_table
t = make_synthetic_table(100_000, 16, seed=0, key_space=100_000)
write_sparse_model(f"{sys.argv[1]}/t0", t.keys, t.vectors)
json.dump({"models": [{"model": "dlrm", "sparse_files": [f"{sys.argv[1]}/t0"],
                       "embedding_vecsize_per_table": [16],
                       "maxnum_catfeature_query_per_table_per_sample": [26],
                       "max_batch_size": 64, "gpucacheper": 1.0,
                       "embedding_cache_type": "static"}]},
          open(f"{sys.argv[1]}/ps.json", "w"))
PY
python - "$ROOT/ps.json" "$ROOT/port" "$DEV" <<'PY' &
import sys, threading
from hugectr_backend_tpu_torch.serving.server import serve
server = serve(sys.argv[1], port=0, block=False, grpc_port=None, device=sys.argv[3])
open(sys.argv[2] + ".tmp", "w").write(str(server.port))
__import__("os").rename(sys.argv[2] + ".tmp", sys.argv[2])
threading.Event().wait()
PY
SERVER=$!
for _ in $(seq 240); do [ -s "$ROOT/port" ] && break; sleep 0.5; done
python -m "$PKG.tools.perf_client" --url "http://127.0.0.1:$(cat "$ROOT/port")" \
  --duration 2 --concurrency 2 --binary
kill "$SERVER"
SERVER=

echo "== bench smoke on $DEV"
HPS_BENCH_SMOKE=1 python -m "$PKG.bench" --device "$DEV" > /dev/null

echo "== auc_parity smoke on $DEV"
HPS_AUC_SMOKE=1 python -m "$PKG.scripts.auc_parity" --device "$DEV" > /dev/null

echo "== frontend_saturation smoke (the device stubbed; the server booted on $DEV)"
HPS_SAT_SMOKE=1 python -m "$PKG.scripts.frontend_saturation" --device "$DEV" > /dev/null

echo "CI OK ($DEVICE)"
