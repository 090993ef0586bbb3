"""The port's ``microbench_update_storm`` and ``microbench_scaling`` against
the JAX package's scripts (imported by path): the storm's configuration
and result keys, and the scaling table's plan and exchange accounting
against the JAX package's all_to_all plan on the same slots. On the CPU, at
small sizes.
"""

import ast
from pathlib import Path

import numpy as np

from hugectr_backend_tpu.parallel import sharded_table as jst
from hugectr_backend_tpu_torch.scripts import microbench_scaling as ms
from hugectr_backend_tpu_torch.scripts import microbench_update_storm as mu

from torch_examples_common import one_torch_thread  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parent.parent


def _source(name):
    return (ROOT / "scripts" / f"{name}.py").read_text()


def _module_constants(name) -> dict:
    out = {}
    for node in ast.parse(_source(name)).body:
        if isinstance(node, ast.Assign):
            try:
                value = ast.literal_eval(node.value)
            except ValueError:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = value
                elif isinstance(t, ast.Tuple):
                    out.update({e.id: v for e, v in zip(t.elts, value)})
    return out


def test_storm_configuration_and_keys_match_the_jax_script(one_torch_thread):
    c = _module_constants("microbench_update_storm")
    assert (mu.ROWS, mu.DIM, mu.UPDATE_BATCH, mu.LOOKUP_BATCH) == (
        c["ROWS"], c["DIM"], c["UPDATE_BATCH"], c["LOOKUP_BATCH"])
    tree = ast.parse(_source("microbench_update_storm"))
    main = next(f for f in tree.body if isinstance(f, ast.FunctionDef) and f.name == "main")
    out = next(n for n in ast.walk(main) if isinstance(n, ast.Dict)
               and any(isinstance(k, ast.Constant) and k.value == "metric" for k in n.keys))
    want = {k.value for k in out.keys} - {"metric", "note"}
    line = mu.run("cpu", seconds=1.0, rows=20_000, warm=5, base=20, emit=lambda x: None)
    assert want <= set(line), sorted(want - set(line))
    assert line["batches_applied"] == line["batches_posted"] > 0
    assert line["device"] == "cpu"


def test_scaling_plan_matches_the_jax_package(one_torch_thread):
    """The bucket capacity of the all_to_all plan (the port's and the JAX
    package's ``plan_all_to_all`` on the same slots), and the exchange
    bytes of the JAX script's formulas."""
    c = _module_constants("microbench_scaling")
    assert (ms.N, ms.D, ms.ROWS, ms.REPS) == (c["N"], c["D"], c["ROWS"], c["REPS"])
    rows, n = 20_000, 512
    lines = ms.run("cpu", rows=rows, n=n, shards=(2, 4), reps=2, emit=lambda x: None)
    rng = np.random.default_rng(0)
    keys = np.sort(rng.choice(np.int64(1) << 40, size=rows, replace=False))
    rng.standard_normal((rows, ms.D))
    hot = rng.permutation(rows)
    order = np.argsort(keys, kind="stable")
    for line in lines:
        p = line["shards"]
        shard_rows = -((rows + 1) // -p)
        caps = []
        for s in range(5):
            r = np.random.default_rng(s)
            slots = order[np.searchsorted(keys[order], keys[hot[r.zipf(1.05, n) % rows]])]
            caps.append(jst.plan_all_to_all(slots.astype(np.int32), p, shard_rows)[0].shape[1])
        assert line["a2a_bucket_cap_rows"] == int(np.median(caps))
        cap = line["a2a_bucket_cap_rows"]
        assert line["a2a_exchange_bytes_per_shard"] == (p - 1) * cap * ms.D * 4
        assert line["psum_exchange_bytes_per_shard"] == int(2 * (p - 1) / p * n * ms.D * 4)
        assert line["a2a_wall_us_median"] > 0 and "a2a_device_us" not in line
