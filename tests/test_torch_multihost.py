"""The port's sharded tables over a mesh of two processes (``torch.distributed``
with gloo), held against the JAX package's single-process mesh of 8 virtual
CPU devices (the JAX package runs the same code over ``jax.distributed`` in
tests/test_multihost.py).

Two worker processes import only the port. They rendezvous through a
``FileStore`` in ``tmp_path`` (no port to race for); each holds 4 of the 8
shards. Each runs the psum and all_to_all lookups, the gradient through the
all_to_all exchange of an f32 table, and ``entry.dryrun_multichip(8)`` over
the process group, then writes its results; the parent compares them with
the JAX package's.

Tolerances: lookups bit-identical to JAX's (int8 rows, one f32 multiply,
exact zeros added); the gradient within rtol 1e-6 of ``jax.grad`` (JAX sums
its shards' copies in another order), its untouched rows exactly 0.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

REPO = str(Path(__file__).resolve().parent.parent)
TIMEOUT = 240

_WORKER = r"""
import dataclasses, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist

rank, store_path, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store_path, 2), rank=rank, world_size=2)
from hugectr_backend_tpu_torch.parallel.mesh import make_mesh
from hugectr_backend_tpu_torch.parallel.sharded_table import (
    ShardedTable, lookup_tables, route, sharded_lookup)

cpu = torch.device("cpu")
mesh = make_mesh(table=8, devices=[cpu] * 4, group=dist.group.WORLD)
assert mesh.shape["table"] == 8 and mesh.local_shards == 4

rng = np.random.default_rng(7)
keys = rng.choice(10 ** 8, size=5000, replace=False).astype(np.int64)
vecs = rng.normal(size=(5000, 32)).astype(np.float32)
tbl = ShardedTable.from_numpy(keys, vecs, mesh, quant="int8")
assert tbl.shard_ids == list(range(4 * rank, 4 * rank + 4))
q = keys[::7][:512]
slots = tbl.slots_for(q)
psum = sharded_lookup(tbl, slots)
a2a = sharded_lookup(tbl, slots, strategy="all_to_all")
miss = sharded_lookup(tbl, tbl.slots_for(np.asarray([-123456789], np.int64)))

# The gradient THROUGH the all_to_all exchange (an f32 table): d/dv
# sum(rows ** 2) lands on the owner shards only.
ft = ShardedTable.from_numpy(keys, vecs, mesh, quant="fp32")
shards = [v.clone().requires_grad_(True) for v in ft.values]
rows = lookup_tables([dataclasses.replace(ft, values=shards)],
                     [route(ft, slots, "all_to_all")], "all_to_all")[0]
grads = torch.autograd.grad((rows ** 2).sum(), shards)

from hugectr_backend_tpu_torch.entry import dryrun_multichip
dry = dryrun_multichip(8, device="cpu")
np.savez(out, psum=psum.numpy(), a2a=a2a.numpy(), miss=miss.numpy(),
         grads=torch.stack(grads).numpy(), shard_ids=np.asarray(ft.shard_ids),
         loss=dry["loss"])
assert "jax" not in sys.modules and "hugectr_backend_tpu" not in sys.modules
dist.destroy_process_group()
print(f"WORKER{{rank}}-OK", flush=True)
"""


def _jax_reference():
    from hugectr_backend_tpu.parallel.mesh import make_mesh
    from hugectr_backend_tpu.parallel.sharded_table import (
        ShardedTable,
        _cached_a2a,
        plan_all_to_all,
        sharded_lookup,
    )

    mesh = make_mesh(table=8)
    rng = np.random.default_rng(7)
    keys = rng.choice(10 ** 8, size=5000, replace=False).astype(np.int64)
    vecs = rng.normal(size=(5000, 32)).astype(np.float32)
    tbl = ShardedTable.from_numpy(keys, vecs, mesh, quant="int8")
    q = keys[::7][:512]
    slots = tbl.slots_for(q)
    out = {"psum": np.asarray(sharded_lookup(tbl, jnp.asarray(slots))),
           "a2a": np.asarray(sharded_lookup(tbl, slots, strategy="all_to_all")),
           "miss": np.asarray(sharded_lookup(tbl, jnp.asarray(
               tbl.slots_for(np.asarray([-123456789], np.int64)))))}
    ft = ShardedTable.from_numpy(keys, vecs, mesh, quant="fp32")
    buckets, expand = plan_all_to_all(slots, 8, ft.rows_padded // 8)
    fn = _cached_a2a(mesh, False)
    out["grad"] = np.asarray(jax.grad(lambda v: (fn(
        v, jnp.asarray(buckets), jnp.asarray(expand)) ** 2).sum())(ft.values))
    out["slots"], out["rows_padded"] = slots, ft.rows_padded
    return out


def test_two_process_sharded_lookup_gradient_and_dry_run(tmp_path, cpu_devices):
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=REPO))
    store = tmp_path / "store"
    outs = [tmp_path / f"rank{i}.npz" for i in range(2)]
    procs = [subprocess.Popen([sys.executable, str(script), str(i), str(store), str(outs[i])],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {i} failed:\n{log[-3000:]}"
        assert f"WORKER{i}-OK" in log

    want = _jax_reference()
    res = [np.load(o) for o in outs]
    for r in res:
        for name in ("psum", "a2a", "miss"):
            assert np.array_equal(r[name].view(np.int32), want[name].view(np.int32)), name
        assert float(r["loss"]) == float(res[0]["loss"])
    np.testing.assert_array_equal(res[0]["miss"], 0.0)
    # Both ranks' shards, in shard order, against JAX's physical blocks.
    grads = np.concatenate([r["grads"] for r in res])
    ids = np.concatenate([r["shard_ids"] for r in res])
    assert list(ids) == list(range(8))
    rows = want["rows_padded"] // 8
    touched = np.zeros(want["rows_padded"], bool)
    touched[want["slots"]] = True
    for k in range(8):
        np.testing.assert_allclose(grads[k], want["grad"][k * rows:(k + 1) * rows],
                                   rtol=1e-6, atol=0.0)
        assert (grads[k][~touched[k::8]] == 0).all()
        assert np.abs(grads[k][touched[k::8]]).sum() > 0
