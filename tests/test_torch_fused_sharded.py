"""Sharded fused serving in the PyTorch port: multi-table DCN-v2 over a
(data x table) mesh (``parallel/fused_sharded.py``), against the JAX
package's on its 8 virtual CPU devices (tests/test_fused_sharded.py). The
Flax weights are carried across with ``load_flax_dcn_params``; the port's
mesh is 2 x 4 entries on the host.

Tolerances:
- logits against the JAX package: rtol 1e-4 / atol 1e-5, the bar of the zoo
  tests (tests/test_torch_zoo.py): the lookups are bit-identical, both sides
  compute the dense forward in f32 and differ only in summation order;
- psum against all_to_all, the split over distinct data devices against
  one forward, and the sharded against the unsharded lookup: bit-identical
  (the same rows into the same forward).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hugectr_backend_tpu.models.dcn import DCNv2 as FlaxDCNv2
from hugectr_backend_tpu.parallel.fused_sharded import ShardedFusedServer as JServer
from hugectr_backend_tpu.parallel.fused_sharded import make_sharded_dcn_server as jmake
from hugectr_backend_tpu.parallel.mesh import make_mesh as jmake_mesh
from hugectr_backend_tpu.parallel.sharded_table import ShardedTable as JTable
from hugectr_backend_tpu_torch.io.synthetic import make_synthetic_table
from hugectr_backend_tpu_torch.models.dcn import DCNv2, load_flax_dcn_params
from hugectr_backend_tpu_torch.parallel import fused_sharded as tfs
from hugectr_backend_tpu_torch.parallel.fused_sharded import (
    ShardedFusedServer,
    make_sharded_dcn_server,
    make_sharded_dlrm_server,
    make_sharded_stacked_server,
)
from hugectr_backend_tpu_torch.parallel.mesh import make_mesh
from hugectr_backend_tpu_torch.parallel.sharded_table import ShardedTable, sharded_lookup

CPU = torch.device("cpu")
B, ND, DIM = 8, 4, 8
KPS = [1, 1, 2]
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def sharded_dcn(cpu_devices):
    jmesh = jmake_mesh(table=4, data=2)
    tmesh = make_mesh(table=4, data=2, devices=[CPU] * 8)
    tbls = [make_synthetic_table(600 + 100 * t, DIM, seed=120 + t) for t in range(3)]
    jtables = [JTable.from_numpy(t.keys, t.vectors, jmesh, quant="int8") for t in tbls]
    ttables = [ShardedTable.from_numpy(t.keys, t.vectors, tmesh, quant="int8") for t in tbls]
    fmodel = FlaxDCNv2(num_cross_layers=2, cross_rank=8, deep_widths=(32,), head_widths=(16, 1))
    mp = fmodel.init(jax.random.PRNGKey(0), jnp.zeros((B, ND)), jnp.zeros((B, 4, DIM)))
    tree = jax.tree_util.tree_map(np.asarray, mp)

    def port_model():
        m = DCNv2(ND, sum(KPS), DIM, num_cross_layers=2, cross_rank=8, deep_widths=(32,),
                  head_widths=(16, 1))
        m.load_state_dict(load_flax_dcn_params(tree))
        return m

    jsrv = jmake(jmesh, jtables, KPS, fmodel, mp)
    tsrv = make_sharded_dcn_server(tmesh, ttables, KPS, port_model())
    return jsrv, tsrv, tbls, fmodel, mp, port_model, jmesh, tmesh


def _keys(tbls, rng, b):
    return [tbls[0].keys[rng.integers(0, 600, (b, 1))],
            tbls[1].keys[rng.integers(0, 700, (b, 1))],
            tbls[2].keys[rng.integers(0, 800, (b, 2))]]


@pytest.mark.parametrize("b", [8, 5])
def test_sharded_dcn_forward_vs_jax(sharded_dcn, b):
    """Logits against the JAX package's server (b = 5 pads to 8 on both
    sides), and against the port's model on the unsharded rows."""
    jsrv, tsrv, tbls, _, _, port_model, _, _ = sharded_dcn
    rng = np.random.default_rng(b)
    keys = _keys(tbls, rng, b)
    dense = rng.standard_normal((b, ND)).astype(np.float32)
    got = tsrv.predict(keys, dense)
    want = np.asarray(jsrv.predict(keys, dense))
    assert got.shape == (b,) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    embs = [sharded_lookup(t, t.slots_for(k.reshape(-1))).view(b, -1, DIM)
            for t, k in zip(tsrv.tables, keys)]
    with torch.no_grad():
        ref = port_model()(torch.from_numpy(dense), torch.cat(embs, dim=1))
    assert torch.equal(got, ref)


def test_sharded_dcn_miss_defaults(sharded_dcn):
    jsrv, tsrv, tbls, _, _, _, _, _ = sharded_dcn
    b = 4
    keys = [np.full((b, 1), -1, np.int64), tbls[1].keys[:b].reshape(b, 1),
            tbls[2].keys[: 2 * b].reshape(b, 2)]
    dense = np.zeros((b, ND), np.float32)
    got = tsrv.predict(keys, dense)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(jsrv.predict(keys, dense)),
                               rtol=RTOL, atol=ATOL)


def test_sharded_dcn_psum_vs_a2a_parity(sharded_dcn):
    """Both strategies give identical logits, and JAX's psum server's."""
    jsrv, tsrv, tbls, fmodel, mp, port_model, jmesh, tmesh = sharded_dcn

    def jassemble(dense, embs):
        return fmodel.apply(mp, dense, jnp.concatenate(embs, axis=1))

    jpsum = JServer(jmesh, jsrv.tables, jsrv.keys_per_sample, jassemble, strategy="psum")
    model = port_model()
    tpsum = ShardedFusedServer(
        tmesh, tsrv.tables, tsrv.keys_per_sample,
        lambda dense, embs: model(dense, torch.cat(embs, dim=1)), strategy="psum")
    rng = np.random.default_rng(3)
    keys = _keys(tbls, rng, B)
    dense = rng.standard_normal((B, ND)).astype(np.float32)
    a2a, psum = tsrv.predict(keys, dense), tpsum.predict(keys, dense)
    assert torch.equal(a2a, psum)
    np.testing.assert_allclose(psum.numpy(), np.asarray(jpsum.predict(keys, dense)),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="unknown strategy"):
        ShardedFusedServer(tmesh, tsrv.tables, KPS, None, strategy="rpc")


def test_split_over_distinct_data_devices(sharded_dcn, monkeypatch):
    """Where the data axis holds distinct devices the batch is split, one
    forward per device: the logits equal one forward's bit for bit. (The
    host's ``cpu`` and ``cpu:0`` are distinct mesh entries.)"""
    _, tsrv, tbls, _, _, port_model, _, _ = sharded_dcn
    mesh = make_mesh(table=4, data=2, devices=[CPU] * 4 + [torch.device("cpu", 0)] * 4)
    split = make_sharded_stacked_server(mesh, tsrv.tables, KPS, port_model())
    assert len(split.data_devices) == 2
    seen = []
    real = split.assemble_fn
    monkeypatch.setattr(split, "assemble_fn", lambda d, e: seen.append(d.shape[0]) or real(d, e))
    rng = np.random.default_rng(9)
    keys = _keys(tbls, rng, B)
    dense = rng.standard_normal((B, ND)).astype(np.float32)
    assert torch.equal(split.predict(keys, dense), tsrv.predict(keys, dense))
    assert seen == [4, 4]


def test_family_aliases():
    assert make_sharded_dcn_server is make_sharded_stacked_server
    assert make_sharded_dlrm_server is make_sharded_stacked_server
    assert tfs.STRATEGIES == ("psum", "all_to_all")
