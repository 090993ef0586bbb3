"""The cross-host DRAM pool in the PyTorch port (``tiers/cluster.py``, the
``redis_cluster`` volatile database, reference
docs/hierarchical_parameter_server.md:423-458) against the JAX package: the
five cases of tests/test_cluster_tier.py on the port, and a node of each
package serving a client of the other.

Tolerance: none. Query answers are compared bit for bit (the nodes store and
return the f32 rows they were sent), and the wire bytes are the same on both
sides, so a JAX node and a port client (and the reverse) interoperate.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hugectr_backend_tpu.tiers.cluster import ClusterKVTier as JaxClusterKVTier
from hugectr_backend_tpu.tiers.cluster import ClusterNodeServer as JaxNode
from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
from hugectr_backend_tpu_torch.io.synthetic import expected_vector, make_synthetic_table
from hugectr_backend_tpu_torch.native.kvstore import NativeDramKVTier
from hugectr_backend_tpu_torch.tiers import cluster
from hugectr_backend_tpu_torch.tiers.cluster import ClusterKVTier, ClusterNodeServer

ROOT = Path(__file__).resolve().parent.parent


def test_cluster_tier_roundtrip_two_nodes():
    n1 = ClusterNodeServer().start()
    n2 = ClusterNodeServer().start()
    try:
        assert isinstance(n1.store, NativeDramKVTier)
        tier = ClusterKVTier([f"127.0.0.1:{n1.port}", f"127.0.0.1:{n2.port}"],
                             max_batch_size=64)
        assert tier.ping()
        rng = np.random.default_rng(0)
        keys = rng.choice(10**8, size=500, replace=False).astype(np.int64)
        vecs = rng.standard_normal((500, 16)).astype(np.float32)
        tier.create_table("t", 16)
        tier.insert("t", keys, vecs)
        # Partitioned across both nodes by low bits.
        assert n1.store.size("t") == int((keys % 2 == 0).sum()) > 0
        assert n1.store.size("t") + n2.store.size("t") == 500 == tier.size("t")
        probe = np.concatenate([keys[::7], np.array([10**12 + 1], np.int64)])
        out, found = tier.query("t", probe)
        assert found[:-1].all() and not found[-1]
        order = np.argsort(keys)
        want = vecs[order][np.searchsorted(keys[order], probe[:-1])]
        np.testing.assert_array_equal(out[:-1], want)
        # Upsert, keys() union, drop.
        tier.insert("t", keys[:10], np.full((10, 16), 5.0, np.float32))
        out2, _ = tier.query("t", keys[:10])
        np.testing.assert_array_equal(out2, 5.0)
        np.testing.assert_array_equal(tier.keys("t"), np.sort(keys))
        tier.drop_table("t")
        assert tier.size("t") == 0
        tier.close()
    finally:
        n1.stop()
        n2.stop()


def test_cluster_tier_cross_process_and_ps_integration(tmp_path):
    """One pool node in a separate OS process and one in-process; the parameter server serves lookups through the pooled
    tier configured as volatile_db type=redis_cluster, on the CPU."""
    from hugectr_backend_tpu_torch import HierParameterServer, LookupSession

    # The child finds the package from this file's checkout, not from a
    # fixed path.
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import threading\n"
        "from hugectr_backend_tpu_torch.tiers.cluster import ClusterNodeServer\n"
        "srv = ClusterNodeServer(port=0).start()\n"
        "print(srv.port, flush=True)\n"
        "threading.Event().wait()\n"
    ) % str(ROOT)
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True)
    try:
        port_remote = int(proc.stdout.readline().strip())
        local = ClusterNodeServer().start()
        try:
            tbl = make_synthetic_table(400, 8, seed=91)
            write_sparse_model(tmp_path / "t0", tbl.keys, tbl.vectors)
            ps = HierParameterServer.create({
                "volatile_db": {
                    "type": "redis_cluster",
                    "address": f"127.0.0.1:{port_remote},127.0.0.1:{local.port}",
                    "initial_cache_rate": 1.0,
                },
                "models": [{
                    "model": "m",
                    "sparse_files": [str(tmp_path / "t0")],
                    "embedding_vecsize_per_table": [8],
                    "maxnum_catfeature_query_per_table_per_sample": [4],
                    "gpucacheper": 0.25,
                    "embedding_cache_type": "dynamic",
                    "quant_bits": 32,
                }],
            }, device="cpu")
            try:
                assert isinstance(ps.dram, ClusterKVTier)
                # Rows live in BOTH processes' DRAM.
                assert local.store.size("hps_et.m.sparse_embedding0") > 0
                assert ps.dram.size("hps_et.m.sparse_embedding0") == 400
                sess = LookupSession.create(ps.get_model_params("m"),
                                            ps.get_embedding_cache("m", 0))
                q = tbl.keys[1::3][:50]
                out = sess.lookup_numpy([q])[0]
                np.testing.assert_array_equal(out, expected_vector(q, 8))
            finally:
                ps.shutdown()
        finally:
            local.stop()
    finally:
        proc.kill()
        proc.wait(timeout=10)


def test_cluster_auth_secret():
    """A good secret round-trips; a bad secret and a secretless client are
    refused before any op — DROP included — runs."""
    node = ClusterNodeServer(secret="s3kr1t").start()
    try:
        good = ClusterKVTier([f"127.0.0.1:{node.port}"], secret="s3kr1t")
        good.create_table("t", 4)
        good.insert("t", np.array([1, 2], np.int64), np.ones((2, 4), np.float32))
        out, found = good.query("t", np.array([1], np.int64))
        assert found.all() and np.array_equal(out, np.ones((1, 4), np.float32))
        bad = ClusterKVTier([f"127.0.0.1:{node.port}"], secret="wrong")
        with pytest.raises(IOError):
            bad.ping()
        bad.close()
        naked = ClusterKVTier([f"127.0.0.1:{node.port}"])
        with pytest.raises(IOError):
            naked.drop_table("t")
        naked.close()
        assert node.store.size("t") == 2  # table untouched
        good.close()
    finally:
        node.stop()


@pytest.fixture(scope="module")
def self_signed_cert(tmp_path_factory):
    if shutil.which("openssl") is None:
        pytest.skip("openssl is not installed")
    tmp = tmp_path_factory.mktemp("tls")
    cert, key = tmp / "cert.pem", tmp / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", str(key),
         "-out", str(cert), "-days", "2", "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
        check=True, capture_output=True, timeout=60)
    return str(cert), str(key)


def test_cluster_tls_and_secret(self_signed_cert):
    """TLS-wrapped node protocol with the secret handshake inside it; a
    plaintext client against the TLS node fails."""
    import ssl

    cert, key = self_signed_cert
    sctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    sctx.load_cert_chain(cert, key)
    node = ClusterNodeServer(secret="tls-pass", tls=sctx).start()
    try:
        cctx = ssl.create_default_context(cafile=cert)
        cctx.check_hostname = False  # self-signed test cert
        tier = ClusterKVTier([f"127.0.0.1:{node.port}"], secret="tls-pass", tls=cctx)
        tier.create_table("t", 4)
        tier.insert("t", np.array([7], np.int64), np.full((1, 4), 2.0, np.float32))
        out, found = tier.query("t", np.array([7], np.int64))
        assert found.all() and np.array_equal(out, np.full((1, 4), 2.0, np.float32))
        tier.close()
        plain = ClusterKVTier([f"127.0.0.1:{node.port}"], timeout_s=3)
        with pytest.raises(IOError):
            plain.ping()
        plain.close()
    finally:
        node.stop()


def test_cluster_fallback_to_local_when_unreachable():
    """An unreachable pool gives the local native store and a warning (the
    reference survives a Redis outage through its persistent full copy)."""
    import logging

    from hugectr_backend_tpu_torch.config.params import VolatileDatabaseParams
    from hugectr_backend_tpu_torch.tiers import dram

    warnings = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: warnings.append(record.getMessage())
    dram.log.addHandler(handler)
    try:
        for address in ("127.0.0.1:1", "no-port-here", ""):
            params = VolatileDatabaseParams.from_json({"type": "redis_cluster",
                                                       "address": address})
            tier = dram.make_dram_tier(params)
            assert isinstance(tier, NativeDramKVTier)
            assert "falling back to the local DRAM store" in warnings.pop()
            tier.create_table("x", 4)
            tier.insert("x", np.array([1], np.int64), np.ones((1, 4), np.float32))
            _, found = tier.query("x", np.array([1], np.int64))
            assert found.all()
    finally:
        dram.log.removeHandler(handler)


def test_make_dram_tier_reaches_the_pool_with_password_and_tls(self_signed_cert):
    """``password`` is the shared secret and ``enable_tls`` with
    ``tls_ca_certificate`` wraps the connections (the reference's redis
    options)."""
    import ssl

    from hugectr_backend_tpu_torch.config.params import VolatileDatabaseParams
    from hugectr_backend_tpu_torch.tiers.dram import make_dram_tier

    cert, key = self_signed_cert
    sctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    sctx.load_cert_chain(cert, key)
    nodes = [ClusterNodeServer(secret="pw").start(),
             ClusterNodeServer(secret="pw", tls=sctx).start()]
    try:
        for node, tls in zip(nodes, (False, True)):
            params = VolatileDatabaseParams.from_json({
                "type": "redis_cluster", "address": f"127.0.0.1:{node.port}",
                "password": "pw", "enable_tls": tls, "tls_ca_certificate": cert,
                "tls_server_name_identification": "localhost"})
            tier = make_dram_tier(params)
            assert isinstance(tier, ClusterKVTier)
            tier.insert("t", np.array([3, 4], np.int64), np.ones((2, 2), np.float32))
            assert node.store.size("t") == 2
            tier.close()
    finally:
        for node in nodes:
            node.stop()


def _exercise(tier) -> list:
    """One fixed sequence of every op -> the answers, for a bit-for-bit
    comparison across packages."""
    rng = np.random.default_rng(3)
    keys = rng.choice(10**9, size=300, replace=False).astype(np.int64)
    keys[:4] = [-3, -8, 0, 2**62]
    vecs = rng.standard_normal((300, 8)).astype(np.float32)
    vecs[0, 0] = -0.0
    tier.create_table("a", 8)
    tier.insert("a", keys, vecs)
    tier.insert("a", keys[:7], vecs[:7] * 3)
    out, found = tier.query("a", np.concatenate([keys[::3], [17, -99]]))
    unknown = tier.query("zz", keys[:3])
    ans = [out, found, tier.size("a"), tier.keys("a"), sorted(tier.tables()),
           unknown[0].shape, unknown[1]]
    tier.drop_table("a")
    ans.append(tier.size("a"))
    return ans


@pytest.mark.parametrize("node_pkg, client_pkg", [("jax", "torch"), ("torch", "jax"),
                                                   ("torch", "torch")])
def test_interop_bit_identical(node_pkg, client_pkg):
    """Nodes of one package behind a client of the other (two nodes, one
    with a secret), answers bit-identical to an all-JAX pool's."""
    node_cls = {"jax": JaxNode, "torch": ClusterNodeServer}
    client_cls = {"jax": JaxClusterKVTier, "torch": ClusterKVTier}
    answers = []
    for n_pkg, c_pkg in (("jax", "jax"), (node_pkg, client_pkg)):
        nodes = [node_cls[n_pkg](secret="k").start() for _ in range(2)]
        try:
            tier = client_cls[c_pkg]([f"127.0.0.1:{n.port}" for n in nodes], secret="k",
                                     max_batch_size=32)
            answers.append(_exercise(tier))
            tier.close()
        finally:
            for n in nodes:
                n.stop()
    for want, got in zip(*answers):
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()
        else:
            assert got == want


def test_wire_constants_match_the_jax_package():
    from hugectr_backend_tpu.tiers import cluster as jcluster

    for name in ("OP_PING", "OP_CREATE", "OP_DROP", "OP_INSERT", "OP_QUERY", "OP_KEYS",
                 "OP_SIZE", "OP_TABLES", "ST_OK", "ST_ERR", "_AUTH_MAGIC", "_NONCE_LEN"):
        assert getattr(cluster, name) == getattr(jcluster, name)
    assert cluster._auth_digest("s", b"n" * 16) == jcluster._auth_digest("s", b"n" * 16)


def test_chip_smoke_cluster_rehearsal(tmp_path, monkeypatch):
    """chip_smoke's cluster phase on the CPU at a small size (4 tables capped
    at 4,096 rows, D 16, batch 256): two node processes with a secret and
    TLS, the dynamic deployment on them against a CPU instance on the local
    store (the "card" instance is a CPU instance too; no K1 launch)."""
    import torch

    if shutil.which("openssl") is None:
        pytest.skip("openssl is not installed")
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke as cs

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    cards = [min(c, 4096) for c in cs.CRITEO_CARDS[:4]]
    tables, _ = cs.build_deployment(str(tmp_path), cards, 16, cs.SEED)
    lines = []
    out = cs.cluster_phase(torch.device("cpu"), str(tmp_path), tables, batch=256,
                           emit_line=lines.append)
    assert out["launches"] == {} and out["nodes"] == 2 and min(out["rows_per_node"]) > 0
    assert len(out["lookup_ms"]) == cs.CLUSTER_BATCHES and out["tier"]["found"] > 0
    assert [ln["cluster"] for ln in lines] == ["pool"]
