"""Phase split of the warp-per-sample interaction kernel (K3) at the fold
predict's inputs: where one sample's time goes, and how the batch fills the
card.

    python3 hugectr_backend_tpu_torch/scripts/k3_phase_split.py --tree DIR

``DIR`` holds a source tree whose ``csrc/dot_interaction.cu`` is the
kernel in which one warp owns one sample, loads its fed rows, builds its
one-hot rows one member at a time, runs the product and stores (the design
the persistent-grid kernel replaced; the script finds its phases by their
source lines and refuses another kernel). It copies that source, stamps
``%globaltimer`` and ``clock64`` at the phase boundaries of warp 0 of every
128th CTA and at each CTA's start and end, builds it with ``nvcc`` beside
the copy, runs it once at the recorded fold-predict inputs of ``DIR``'s
``chip_smoke.py`` deployment, and prints one JSON line: the CTAs, warps per
CTA, CTAs an SM holds (occupancy), the waves, the CTAs' start times and
lifetimes, and per stamped warp the fed-row loads, the one-hot build, the
product and the store issue, in µs and cycles. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

_HEAD = """
__device__ unsigned long long hps_ts[64 * 8];
__device__ long long hps_ck[64 * 8];
__device__ unsigned long long hps_blk[8192 * 2];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t; asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t)); return t; }
"""
_READ = r"""
extern "C" int hps_read(unsigned long long* ts, long long* ck, unsigned long long* blk) {
  cudaMemcpyFromSymbol(ts, hps_ts, sizeof(hps_ts));
  cudaMemcpyFromSymbol(ck, hps_ck, sizeof(hps_ck));
  return (int)cudaMemcpyFromSymbol(blk, hps_blk, sizeof(hps_blk)); }
extern "C" int hps_occ(int smem, int threads) { int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, dot_interaction_kernel<int8_t, true>,
                                                threads, smem);
  return n; }
"""


def _stamp(k: int) -> str:
    return ("if (lane == 0 && (blockIdx.x % 128) == 0 && warp == 0) { int s_ = blockIdx.x / 128; "
            f"hps_ts[s_ * 8 + {k}] = gtime(); hps_ck[s_ * 8 + {k}] = clock64(); }}\n")


def stamped_source(src: str) -> str:
    """The kernel source with the stamps in; raises if a phase's line is
    not there (another kernel)."""
    src = src.replace("namespace {\n", "namespace {\n" + _HEAD, 1)
    edits = [
        ("  const int n_fed = 1 + p.n_feats;\n",
         "  const int n_fed = 1 + p.n_feats;\n"
         "  if (threadIdx.x == 0) hps_blk[2 * blockIdx.x] = gtime();\n"),
        ("    float* out_row = p.out + b * p.out_ld;\n",
         "    float* out_row = p.out + b * p.out_ld;\n" + _stamp(0)),
        ("    // Gathered one-hot rows (K3)", _stamp(1) + "    // Gathered one-hot rows (K3)"),
        ("    // Upper triangle of z z^T", _stamp(2) + "    // Upper triangle of z z^T"),
        ("    for (int q = lane; q < p.P; q += 32) out_row[p.D + q] = stage[q];\n",
         _stamp(3) + "    for (int q = lane; q < p.P; q += 32) out_row[p.D + q] = stage[q];\n"),
        ("    __syncwarp();  // the next sample overwrites z and the stage\n  }\n",
         "    __syncwarp();  // the next sample overwrites z and the stage\n" + _stamp(4)
         + "  }\n  __syncthreads();\n"
         "  if (threadIdx.x == 0) hps_blk[2 * blockIdx.x + 1] = gtime();\n"),
    ]
    for a, b in edits:
        if a not in src:
            raise ValueError(f"not the warp-per-sample kernel: no line {a.strip()!r}")
        src = src.replace(a, b, 1)
    return src + _READ


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, help="the source tree whose kernel to stamp")
    tree = os.path.abspath(ap.parse_args(argv).tree)
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k3_phase_split: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from hugectr_backend_tpu_torch import HierParameterServer
    from hugectr_backend_tpu_torch.ops import fused_interaction as fi
    from hugectr_backend_tpu_torch.ops import kernels
    from hugectr_backend_tpu_torch.scripts.common import graph_us
    from hugectr_backend_tpu_torch.serving.program import make_dlrm_multi_server

    work = tempfile.mkdtemp(prefix="hps_k3_split_")
    src = os.path.join(work, "k3_stamped.cu")
    with open(os.path.join(tree, "hugectr_backend_tpu_torch/csrc/dot_interaction.cu")) as f:
        text = stamped_source(f.read())
    with open(src, "w") as f:
        f.write(text)
    lib_path = os.path.join(work, "k3_stamped.so")
    subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", lib_path, src], check=True)
    stamped = ctypes.CDLL(lib_path)
    stamped.hps_cuda_error_string.restype = ctypes.c_char_p

    kernels.build_all()
    cards = [min(c, cs.ROW_CAP) for c in cs.CRITEO_CARDS]
    with tempfile.TemporaryDirectory(prefix="hps_k3_split_deploy_") as root:
        tables, cfg = cs.build_deployment(root, cards, cs.DIM, cs.SEED)
        ps = HierParameterServer.create(cfg)
    cache = ps.get_embedding_cache("dlrm", 0)
    srv = make_dlrm_multi_server(ps.get_model_params("dlrm"), cache,
                                 cs.make_model(len(cards), cs.SEED))
    batches = cs.make_batches(tables, cs.BATCH, 1, cs.SEED + 1)
    with cs.Recorder() as rec:
        cs.predict_sync(srv, *batches[0])
    args = rec.calls["dot_interaction_oh_parts"][0]
    kernels._libs["dot_interaction"] = stamped
    fi._bound = False
    run = lambda: fi.dot_interaction_oh_parts(*args)  # noqa: E731
    run()
    torch.cuda.synchronize()
    us = graph_us([run] * 20)
    run()
    torch.cuda.synchronize()
    ts, ck = (ctypes.c_ulonglong * 512)(), (ctypes.c_longlong * 512)()
    blk = (ctypes.c_ulonglong * 16384)()
    stamped.hps_read(ts, ck, blk)
    bottom, slots = args[0], args[2]
    b, d = bottom.shape
    feats = 1 + slots.shape[0] + len(args[5])
    pairs = feats * (feats - 1) // 2
    per_warp = -(-feats // 16) * 16 * (-(-d // 16) * 16 + 8) * 2 + ((pairs + 3) & ~3) * 4
    warps = min(8, max(1, 48 * 1024 // per_warp))
    ctas = -(-b // warps)
    occ = stamped.hps_occ(per_warp * warps, warps * 32)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    life = np.array(blk[: 2 * ctas], dtype=np.float64).reshape(-1, 2)
    t0 = life[:, 0].min()
    starts, ends = (life[:, 0] - t0) / 1e3, (life[:, 1] - t0) / 1e3
    hist, edges = np.histogram(starts, bins=8)
    phases = []
    for s in range(0, ctas, 128):
        t = [ts[s // 128 * 8 + k] for k in range(5)]
        c = [ck[s // 128 * 8 + k] for k in range(5)]
        phases.append({"cta": s, "start_us": (t[0] - t0) / 1e3,
                       **{f"{n}_us": (t[i + 1] - t[i]) / 1e3 for i, n in
                          enumerate(("fed", "onehot", "product", "stores"))},
                       **{f"{n}_cycles": c[i + 1] - c[i] for i, n in
                          enumerate(("fed", "onehot", "product", "stores"))}})
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(json.dumps({"k3_phase_split": {
        "tree": tree, "features": feats, "warps_per_cta": warps, "smem_per_cta": per_warp * warps,
        "ctas": ctas, "ctas_per_sm": occ, "resident_warps_per_sm": occ * warps,
        "waves": ctas / (occ * sms), "graph_us": us, "span_us": float(ends.max()),
        "start_histogram": hist.tolist(), "start_edges_us": edges.round(2).tolist(),
        "cta_lifetime_median_us": float(np.median(ends - starts)), "phases": phases},
        "card": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
