"""The public names of the JAX package that the port carries since its last
symbol diff (ops/quantize.py ``dequantize_rows`` and ``_int4``, the ops /
cache / utils exports, ``CacheConfig`` and ``EmbeddingCache.get_cache_config``,
``LookupSession.num_samples_of``, ``KeyIndex.contains``, the switches
``HPS_TPU_NATIVE_QUANTIZE``, ``HPS_TPU_NATIVE_INDEX``, ``_MIN_ROWS`` and
``_MAX_ROWS``, and utils/tracing.py's ``start_trace`` / ``stop_trace`` and
``HPS_TPU_DISABLE_TRACING``), each held against the JAX package on the same
inputs. Nothing here launches a kernel."""

import importlib
import json

import numpy as np
import pytest

import hugectr_backend_tpu as jpkg
import hugectr_backend_tpu_torch as tpkg
from hugectr_backend_tpu.io.sparse_model import write_sparse_model
from hugectr_backend_tpu.io.synthetic import make_synthetic_table
from hugectr_backend_tpu.ops import quantize as jq
from hugectr_backend_tpu.tiers import hbm as jhbm
from hugectr_backend_tpu_torch.ops import quantize as tq
from hugectr_backend_tpu_torch.tiers import hbm as thbm

from test_torch_import import EXPORTS


@pytest.mark.parametrize("pkg", list(EXPORTS))
def test_exports_are_the_jax_packages(pkg):
    jax_pkg = importlib.import_module(pkg.replace("hugectr_backend_tpu_torch",
                                                  "hugectr_backend_tpu"))
    port = importlib.import_module(pkg)
    assert sorted(port.__all__) == sorted(jax_pkg.__all__) == sorted(EXPORTS[pkg])


def test_utils_timer_is_the_timer():
    from hugectr_backend_tpu_torch.utils import Timer, timer

    assert Timer is timer.Timer


# -- ops/quantize.py ----------------------------------------------------------


def _rows(n=300, d=24, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, d)).astype(np.float32)
    v[3] = 0.0  # an all-zero row: scale 1 / Q
    v[7, :] = -2.5  # a constant row
    return v


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_rows_bit_for_bit(bits):
    v = _rows()
    order = np.random.default_rng(1).permutation(v.shape[0])[:200]
    if bits == 8:
        q, s = jq.quantize_rows_int8(v, order)
        want, got = jq.dequantize_rows(q, s), tq.dequantize_rows(q, s)
    else:
        q, s = jq.quantize_rows_int4(v, order)
        want, got = jq.dequantize_rows_int4(q, s), tq.dequantize_rows_int4(q, s)
    assert got.dtype == want.dtype == np.float32 and got.shape == (200, v.shape[1])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("value", ["0", "1", None, "yes"])
@pytest.mark.parametrize("bits", [8, 4])
def test_native_quantize_switch(monkeypatch, bits, value):
    """``HPS_TPU_NATIVE_QUANTIZE``: "0" takes the numpy chain, anything else
    (or nothing) the native quantizer; the rows and scales are the JAX
    package's either way (its own switch set alike)."""
    if value is None:
        monkeypatch.delenv("HPS_TPU_NATIVE_QUANTIZE", raising=False)
    else:
        monkeypatch.setenv("HPS_TPU_NATIVE_QUANTIZE", value)
    calls = []
    native = tq._native_quantize
    monkeypatch.setattr(tq, "_native_quantize",
                        lambda *a, **k: calls.append(1) or native(*a, **k))
    v = _rows(seed=2)
    order = np.arange(v.shape[0])[::-1].copy()
    port = tq.quantize_rows_int8 if bits == 8 else tq.quantize_rows_int4
    ref = jq.quantize_rows_int8 if bits == 8 else jq.quantize_rows_int4
    (q, s), (qj, sj) = port(v, order), ref(v, order)
    np.testing.assert_array_equal(q, qj)
    np.testing.assert_array_equal(s, sj)
    assert len(calls) == (0 if value == "0" else 1)


# -- cache/embedding_cache.py, lookup/session.py: one ps.json in both ---------

TABLES = {"a": (500, 16), "b": (800, 8)}
KPS = [2, 3]


@pytest.fixture(scope="module")
def sparse_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("surface")
    for i, (name, (rows, dim)) in enumerate(TABLES.items()):
        t = make_synthetic_table(rows, dim, seed=70 + i)
        write_sparse_model(root / name, t.keys, t.vectors)
    return root


def _cfg(root, cache_type):
    model = {"model": "m", "sparse_files": [str(root / t) for t in TABLES],
             "embedding_vecsize_per_table": [d for _, d in TABLES.values()],
             "maxnum_catfeature_query_per_table_per_sample": KPS,
             "gpucacheper": 0.5, "quant_bits": 8}
    if cache_type is not None:
        model["embedding_cache_type"] = cache_type
    return {"models": [model]}


@pytest.fixture(params=["static", None, "uvm"], ids=["static", "dynamic", "uvm"])
def both(request, sparse_files, tmp_path):
    path = tmp_path / "ps.json"
    path.write_text(json.dumps(_cfg(sparse_files, request.param)))
    jps = jpkg.HierParameterServer.create(str(path))
    tps = tpkg.HierParameterServer.create(str(path), device="cpu")
    yield jps, tps
    tps.shutdown()
    jps.shutdown()


def test_cache_config_field_by_field(both):
    jps, tps = both
    want = jps.get_embedding_cache("m", 0).get_cache_config()
    got = tps.get_embedding_cache("m", 0).get_cache_config()
    from hugectr_backend_tpu_torch.cache import CacheConfig

    assert isinstance(got, CacheConfig)
    assert got.num_emb_table == want.num_emb_table == len(TABLES)
    assert got.embedding_vec_size == want.embedding_vec_size
    assert got.capacity_per_table == want.capacity_per_table
    assert got.cache_type.value == want.cache_type.value


def test_num_samples_of(both):
    jps, tps = both
    sessions = [pkg.LookupSession.create(ps.get_model_params("m"),
                                         ps.get_embedding_cache("m", 0))
                for pkg, ps in ((jpkg, jps), (tpkg, tps))]
    cat = sum(KPS)
    for n in (0, cat, 7 * cat):
        keys = np.arange(n, dtype=np.int64)
        assert sessions[1].num_samples_of(keys) == sessions[0].num_samples_of(keys) == n // cat
    for n in (1, cat + 1, 2 * cat - 1):
        errors = []
        for s in sessions:
            with pytest.raises(ValueError) as e:
                s.num_samples_of(np.zeros(n, np.int64))
            errors.append(str(e.value))
        assert errors[0] == errors[1]


def test_num_samples_of_with_cat_num_zero():
    """A model of no categorical keys: every KEYS length raises, with the
    JAX package's message."""
    from types import SimpleNamespace

    errors = []
    for pkg in (jpkg, tpkg):
        s = pkg.LookupSession(SimpleNamespace(cat_num=0), None)
        with pytest.raises(ValueError) as e:
            s.num_samples_of(np.zeros(5, np.int64))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# -- tiers/hbm.py: KeyIndex.contains and the native-index switches ------------


def _keys(direct: bool, n=400, seed=3):
    if direct:
        return np.random.default_rng(seed).permutation(n).astype(np.int64)
    return np.random.default_rng(seed).choice(10 ** 9, n, replace=False).astype(np.int64)


def _queries(keys, seed=4):
    rng = np.random.default_rng(seed)
    hits = rng.choice(keys, 300)
    misses = np.concatenate([rng.integers(-5, 2 * 10 ** 9, 200),
                             [-1, keys.max() + 1, len(keys), 0]]).astype(np.int64)
    q = np.concatenate([hits, misses])
    rng.shuffle(q)
    return q


@pytest.mark.parametrize("direct", [False, True], ids=["hashed", "direct"])
def test_key_index_contains(direct):
    keys = _keys(direct)
    (tidx, _), (jidx, _) = thbm.KeyIndex.build(keys), jhbm.KeyIndex.build(keys)
    assert tidx.direct == jidx.direct == direct
    q = _queries(keys)
    got, want = tidx.contains(q), jidx.contains(q)
    assert got.dtype == bool
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.isin(q, keys))
    assert got.sum() >= 300


# (switch values, whether the table of 400 rows gets the native hash)
INDEX_SWITCHES = [
    ({}, True),
    ({"HPS_TPU_NATIVE_INDEX": "0"}, False),
    ({"HPS_TPU_NATIVE_INDEX": "1"}, True),
    ({"HPS_TPU_NATIVE_INDEX": "false"}, False),
    ({"HPS_TPU_NATIVE_INDEX": "true"}, False),
    ({"HPS_TPU_NATIVE_INDEX_MIN_ROWS": "400"}, True),
    ({"HPS_TPU_NATIVE_INDEX_MIN_ROWS": "401"}, False),
    ({"HPS_TPU_NATIVE_INDEX_MAX_ROWS": "400"}, True),
    ({"HPS_TPU_NATIVE_INDEX_MAX_ROWS": "399"}, False),
]


@pytest.mark.parametrize("env,native", INDEX_SWITCHES,
                         ids=[",".join(f"{k[20:] or 'INDEX'}={v}" for k, v in e.items()) or "unset"
                              for e, _ in INDEX_SWITCHES])
def test_native_index_switches(monkeypatch, env, native):
    """Read when an index is built: the native hash only where the switches
    allow it, as the JAX package builds its own, and the same slots either
    way (the port's searched index against the JAX package's)."""
    for k in ("HPS_TPU_NATIVE_INDEX", "HPS_TPU_NATIVE_INDEX_MIN_ROWS",
              "HPS_TPU_NATIVE_INDEX_MAX_ROWS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    keys = _keys(False)
    (tidx, order), (jidx, jorder) = thbm.KeyIndex.build(keys), jhbm.KeyIndex.build(keys)
    np.testing.assert_array_equal(order, jorder)
    assert (tidx._native is not None) == native == (jidx._native is not None)
    q = _queries(keys)
    np.testing.assert_array_equal(tidx.lookup(q), jidx.lookup(q))
    np.testing.assert_array_equal(tidx.lookup(q), tidx.search(q))
    monkeypatch.delenv("HPS_TPU_NATIVE_INDEX", raising=False)
    monkeypatch.delenv("HPS_TPU_NATIVE_INDEX_MIN_ROWS", raising=False)
    monkeypatch.delenv("HPS_TPU_NATIVE_INDEX_MAX_ROWS", raising=False)
    assert (tidx._native is not None) == native  # read at build time only


# -- utils/tracing.py ---------------------------------------------------------


@pytest.mark.parametrize("value", [None, "0", "false", "1", "true", "yes", "on", " On "])
def test_trace_holds_the_annotated_region_unless_disabled(monkeypatch, tmp_path, value):
    from hugectr_backend_tpu.utils import tracing as jtracing
    from hugectr_backend_tpu_torch.utils import tracing

    if value is None:
        monkeypatch.delenv("HPS_TPU_DISABLE_TRACING", raising=False)
    else:
        monkeypatch.setenv("HPS_TPU_DISABLE_TRACING", value)
    disabled = tracing._tracing_disabled()
    assert disabled == jtracing._tracing_disabled() == (value not in (None, "0", "false"))
    log_dir = tmp_path / "trace"
    tracing.start_trace(str(log_dir))
    with pytest.raises(RuntimeError):
        tracing.start_trace(str(log_dir))
    with tracing.annotate("HpsSurfaceRegion"):
        sum(range(1000))
    path = tracing.stop_trace()
    assert path.startswith(str(log_dir))
    text = (log_dir / path.rsplit("/", 1)[1]).read_text()
    json.loads(text)  # a whole Chrome trace
    assert ("HpsSurfaceRegion" in text) == (not disabled)
    with pytest.raises(RuntimeError):
        tracing.stop_trace()
