"""Triton model repositories in the PyTorch port (``io/model_repo.py``) against
the JAX package: the pbtxt parser, the schema checks, the instance-group and
parameters rules, the repository scan, the version switch and serving from a
repository.

Tolerance: none. The parser returns equal dicts and both packages raise the
same messages; a repository resolves to equal params; served vectors are
bit-identical (f32 tables, the same rows on both sides). The pbtxt texts are
those of tests/test_model_repo.py and tests/test_ensemble.py, loaded from
those files.
"""

import dataclasses
import importlib.util
import json
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from hugectr_backend_tpu.config.params import ConfigError as JaxConfigError
from hugectr_backend_tpu.io import model_repo as jrepo
from hugectr_backend_tpu.serving.model_manager import ModelManager as JaxManager
from hugectr_backend_tpu_torch.config.params import ConfigError
from hugectr_backend_tpu_torch.io import model_repo as trepo
from hugectr_backend_tpu_torch.io.sparse_model import write_sparse_model
from hugectr_backend_tpu_torch.io.synthetic import expected_vector, make_synthetic_table
from hugectr_backend_tpu_torch.serving.model_manager import ModelManager

TESTS = Path(__file__).resolve().parent
TIMEOUT = 30


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", TESTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_JMR = _load("test_model_repo")
_JENS = _load("test_ensemble")
GOOD_PBTXT = _JMR.GOOD_PBTXT

PBTXTS = {
    "good": GOOD_PBTXT,
    "block_style": (
        'name: "m"\n'
        'input { name: "KEYS" data_type: TYPE_INT64 dims: -1 }\n'
        'input { name: "NUMKEYS" data_type: TYPE_INT32 dims: -1 }\n'
        'output { name: "OUT" data_type: TYPE_FP32 dims: -1 }\n'
        'parameters { key: "refresh_delay" value { string_value: "1.5" } }\n'
    ),
    "escapes": 'a: "x \\"q\\" y" # trailing comment\nb: 3.5\nc: true\n',
    "ensemble": _JENS.ENSEMBLE_PBTXT,
    "hps": _JENS.HPS_PBTXT,
    "dense": _JENS.DENSE_PBTXT,
    "sharded_hps": _JENS.SHARDED_HPS_PBTXT,
    "empty": "",
    "repeated_scalars": "a: 1 a: 2 b [1, 2, 3] b: 4 c: -1e-3 d: FALSE",
}

BAD_PBTXTS = [
    'input { name: "KEYS" ',   # unclosed message
    "a:",                      # value missing at EOF
    "a",                       # field without value
    '{ a: 1 }',                # a message where a field name belongs
    'a: "unterminated',        # bad syntax
    "a: [1, 2",                # unclosed list
    "a: 1 }",                  # stray close
]


def _same_error(fn_jax, fn_torch):
    """Both raise their package's ConfigError with the same message, or both
    return equal values."""
    try:
        want = fn_jax()
    except JaxConfigError as e:
        with pytest.raises(ConfigError) as got:
            fn_torch()
        assert str(got.value) == str(e)
        return None
    assert fn_torch() == want
    return want


@pytest.mark.parametrize("name", sorted(PBTXTS))
def test_parse_pbtxt_same_dicts(name):
    got = trepo.parse_pbtxt(PBTXTS[name])
    assert got == jrepo.parse_pbtxt(PBTXTS[name])
    if name == "good":
        assert got["instance_group"][0]["gpus"] == [0]


@pytest.mark.parametrize("text", BAD_PBTXTS)
def test_parse_pbtxt_bad_syntax_same_errors(text):
    with pytest.raises(JaxConfigError) as want:
        jrepo.parse_pbtxt(text)
    with pytest.raises(ConfigError) as got:
        trepo.parse_pbtxt(text)
    assert str(got.value) == str(want.value)


def _mutations():
    def inputs_one(c):
        c["input"] = [{"name": "KEYS"}]

    def keys_int32(c):
        c["input"][0]["data_type"] = "TYPE_INT32"

    def numkeys_int64(c):
        c["input"][1]["data_type"] = "TYPE_INT64"

    def numkeys_fp32(c):
        c["input"][1]["data_type"] = "TYPE_FP32"

    def out_fp16(c):
        c["output"][0]["data_type"] = "TYPE_FP16"

    def two_outputs(c):
        c["output"] = c["output"] * 2

    def dims(c):
        c["input"][1]["dims"] = [2, -1]

    def rename(c):
        c["input"][1]["name"] = "NKEYS"

    def unchanged(c):
        pass

    return {f.__name__: f for f in (inputs_one, keys_int32, numkeys_int64, numkeys_fp32,
                                    out_fp16, two_outputs, dims, rename, unchanged)}


@pytest.mark.parametrize("case", sorted(_mutations()))
def test_validate_same_verdicts(case):
    def cfg():
        c = jrepo.parse_pbtxt(GOOD_PBTXT)
        _mutations()[case](c)
        return c

    _same_error(lambda: jrepo.validate_model_config(cfg(), "m"),
                lambda: trepo.validate_model_config(cfg(), "m"))


# ------------------------------------------------------------------ repo scan


def _make_repo(root, versions=(1,), pbtxt=GOOD_PBTXT, model="wdl", rows=2000, dim=16,
               extra_ps=None):
    mdir = root / model
    mdir.mkdir(parents=True, exist_ok=True)
    (mdir / "config.pbtxt").write_text(pbtxt)
    tbl = make_synthetic_table(rows, dim, seed=7)
    for v in versions:
        write_sparse_model(mdir / str(v) / "sparse0.model", tbl.keys, tbl.vectors)
    ps = {"models": [{
        "model": model,
        "sparse_files": ["sparse0.model"],  # relative -> version dir
        "embedding_vecsize_per_table": [dim],
        "maxnum_catfeature_query_per_table_per_sample": [2],
        "max_batch_size": 32,
        "gpucacheper": 1.0,
        "embedding_cache_type": "static",
        "quant_bits": 32,
        **(extra_ps or {}),
    }]}
    (root / "ps.json").write_text(json.dumps(ps))
    return tbl


_PARAM_FIELDS = ("sparse_files", "deployed_devices", "refresh_interval", "refresh_delay",
                 "freeze_sparse", "max_batch_size", "repo_model_dir", "repo_rel_sparse_files",
                 "num_of_worker_buffer_in_pool")


def _resolved(cfg):
    return {name: {f: getattr(p, f) for f in _PARAM_FIELDS} for name, p in cfg.models.items()}


@pytest.mark.parametrize("case", ["versions_1_3_2", "block_params", "refresh_delay",
                                  "two_gpus", "orphan"])
def test_load_repository_same_params(tmp_path, case):
    pbtxt = GOOD_PBTXT
    extra = None
    if case == "block_params":
        pbtxt = PBTXTS["block_style"].replace('"m"', '"wdl"')
    elif case == "refresh_delay":
        pbtxt = GOOD_PBTXT.replace('"refresh_interval" value: { string_value: "0" }',
                                   '"refresh_delay" value: { string_value: "2.5" }')
    elif case == "two_gpus":
        pbtxt = GOOD_PBTXT.replace("gpus: [ 0 ]", "gpus: [ 1, 0 ]")
        extra = {"deployed_device_list": [0, 1]}
    _make_repo(tmp_path, versions=(1, 3, 2) if case == "versions_1_3_2" else (1,),
               pbtxt=pbtxt, extra_ps=extra)
    if case == "orphan":
        # A repository dir without a ps.json entry: warned and skipped.
        other = tmp_path / "orphan"
        other.mkdir()
        (other / "config.pbtxt").write_text(GOOD_PBTXT.replace('"wdl"', '"orphan"'))
        (other / "1").mkdir()
    jcfg, jversions = jrepo.load_model_repository(tmp_path)
    tcfg, tversions = trepo.load_model_repository(tmp_path, device="cpu")
    assert tversions == jversions
    assert _resolved(tcfg) == _resolved(jcfg)
    assert [m.versions for m in trepo.scan_repository(tmp_path).values()] == \
        [m.versions for m in jrepo.scan_repository(tmp_path).values()]
    p = tcfg.models["wdl"]
    if case == "versions_1_3_2":
        assert tversions == {"wdl": 3}
        assert p.sparse_files == [str(tmp_path / "wdl" / "3" / "sparse0.model")]
        assert p.freeze_sparse is True and p.refresh_interval == 0.0
        assert p.max_batch_size == 32  # ps.json wins over config.pbtxt
    if case == "two_gpus":
        assert p.deployed_devices == [0, 1]


@pytest.mark.parametrize("case", ["name_mismatch", "no_versions", "worker_pool",
                                  "kind_cpu", "no_ps_json", "not_a_dir", "empty"])
def test_repository_errors_identical(tmp_path, case):
    if case == "name_mismatch":
        (tmp_path / "dirname" / "1").mkdir(parents=True)
        (tmp_path / "dirname" / "config.pbtxt").write_text('name: "othername"\n')
    elif case == "no_versions":
        (tmp_path / "dirname").mkdir()
        (tmp_path / "dirname" / "config.pbtxt").write_text('name: "dirname"\n')
    elif case == "worker_pool":
        _make_repo(tmp_path, pbtxt=GOOD_PBTXT.replace("count: 1", "count: 9"))
    elif case == "kind_cpu":
        _make_repo(tmp_path, pbtxt=GOOD_PBTXT.replace("KIND_GPU", "KIND_CPU"))
    elif case == "no_ps_json":
        _make_repo(tmp_path)
        (tmp_path / "ps.json").unlink()
    elif case == "not_a_dir":
        tmp_path = tmp_path / "missing"
    _same_error(lambda: jrepo.load_model_repository(tmp_path),
                lambda: trepo.load_model_repository(tmp_path, device="cpu"))
    if case in ("worker_pool", "name_mismatch", "no_versions"):
        with pytest.raises(ConfigError, match={"worker_pool": "worker_buffer_in_pool",
                                               "name_mismatch": "disagrees",
                                               "no_versions": "version"}[case]):
            trepo.load_model_repository(tmp_path, device="cpu")


def test_model_kinds_identical(tmp_path):
    """Each kind (hps by backend, by platform and by ps.json entry; ensemble;
    dense by platform, by foreign platform and by its spec file; unknown)."""
    configs = {
        "by_backend": 'backend: "hps"', "by_platform": 'platform: "hps"',
        "by_ps_json": 'platform: "custom"', "ens": 'platform: "ensemble"',
        "native_dense": 'platform: "hps_tpu_dense"',
        "torch_dense": 'platform: "pytorch_libtorch"', "spec_dense": 'platform: "x"',
        "other": 'platform: "python"',
    }
    for name, line in configs.items():
        (tmp_path / name / "1").mkdir(parents=True)
        (tmp_path / name / "config.pbtxt").write_text(f'name: "{name}"\n{line}\n')
    (tmp_path / "spec_dense" / "1" / "dense_model.json").write_text("{}")
    ps_models = {"by_ps_json"}
    tk = {n: m.kind(ps_models) for n, m in trepo.scan_repository(tmp_path).items()}
    jk = {n: m.kind(ps_models) for n, m in jrepo.scan_repository(tmp_path).items()}
    assert tk == jk
    assert tk["torch_dense"] == "dense" and tk["by_ps_json"] == "hps"
    assert tk["other"] == "unknown" and tk["ens"] == "ensemble"


def test_foreign_dense_model_hint(tmp_path):
    """A foreign dense platform is classified as dense and fails its load
    with the converter hint, as in the JAX package."""
    from hugectr_backend_tpu.io.dense_model import FOREIGN_DENSE_PLATFORMS as JF
    from hugectr_backend_tpu_torch.io.dense_model import FOREIGN_DENSE_PLATFORMS

    assert FOREIGN_DENSE_PLATFORMS == JF
    (tmp_path / "dense" / "1").mkdir(parents=True)
    (tmp_path / "dense" / "1" / "model.pt").write_bytes(b"not a real torchscript")
    (tmp_path / "dense" / "config.pbtxt").write_text(
        'name: "dense"\nplatform: "pytorch_libtorch"\n')
    _same_error(lambda: jrepo.load_repository(tmp_path),
                lambda: trepo.load_repository(tmp_path, device="cpu"))
    with pytest.raises(ConfigError, match="convert_dense_model"):
        trepo.load_repository(tmp_path, device="cpu")


# -------------------------------------------------------------- version switch


@pytest.mark.parametrize("case", ["switch", "missing_version", "missing_file",
                                  "absolute_path", "not_from_a_repository"])
def test_switch_model_version_identical(tmp_path, case):
    _make_repo(tmp_path, versions=(1, 2))
    if case == "missing_file":
        (tmp_path / "wdl" / "4").mkdir()
    results = []
    for repo in (jrepo, trepo):
        if case == "not_from_a_repository":
            from hugectr_backend_tpu_torch.config.params import ParameterServerConfig

            params = ParameterServerConfig.create(tmp_path / "ps.json").models["wdl"]
        else:
            kw = {} if repo is jrepo else {"device": "cpu"}
            params = repo.load_model_repository(tmp_path, **kw)[0].models["wdl"]
        if case == "absolute_path":
            params.repo_rel_sparse_files = [str(tmp_path / "abs.model")]
        version = {"switch": 1, "missing_version": 7, "missing_file": 4}.get(case, 1)
        results.append((repo.switch_model_version(params, version), params.sparse_files))
    assert results[0] == results[1]
    if case == "switch":
        assert results[1] == (True, [str(tmp_path / "wdl" / "1" / "sparse0.model")])
    if case == "absolute_path":
        assert results[1] == (True, [str(tmp_path / "abs.model")])
    if case in ("missing_version", "missing_file", "not_from_a_repository"):
        assert results[1][0] is False


# ------------------------------------------------------------------------ e2e


def test_serve_from_triton_repository(tmp_path):
    tbl = _make_repo(tmp_path, versions=(1, 2), dim=16)
    keys = tbl.keys[:8].astype(np.int64)
    outs = []
    for repo, mgr_cls, kw in ((jrepo, JaxManager, {}), (trepo, ModelManager, {"device": "cpu"})):
        cfg, versions = repo.load_model_repository(tmp_path, **kw)
        mgr = mgr_cls.create(cfg, load_all=False, **kw)
        try:
            for name, v in versions.items():
                mgr.load(name, version=v)
            assert mgr.is_loaded("wdl")
            assert mgr.loaded_models()[0]["version"] == "2"
            resp = mgr.infer("wdl", keys, np.asarray([8], np.int64))
            outs.append(np.asarray(resp.output))
        finally:
            mgr.shutdown()
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_allclose(outs[1].reshape(8, 16), expected_vector(keys, 16), rtol=1e-5)


def test_version_bump_rereads_new_version_files(tmp_path):
    """A repository version bump through load(version=N) re-reads the NEW
    version dir's sparse files; unload -> load(newer version) does too."""
    tbl = _make_repo(tmp_path, versions=(1,), dim=16)
    cfg, versions = trepo.load_model_repository(tmp_path, device="cpu")
    mgr = ModelManager.create(cfg, load_all=False, device="cpu")
    keys = tbl.keys[:4].astype(np.int64)

    def infer():
        return np.asarray(mgr.infer("wdl", keys, np.asarray([4], np.int64)).output
                          ).reshape(4, 16)

    try:
        mgr.load("wdl", version=1)
        np.testing.assert_allclose(infer(), expected_vector(keys, 16), rtol=1e-5)
        write_sparse_model(tmp_path / "wdl" / "2" / "sparse0.model", tbl.keys,
                           tbl.vectors * 3.0)
        mgr.load("wdl", version=2)
        assert cfg.models["wdl"].sparse_files == [str(tmp_path / "wdl" / "2" / "sparse0.model")]
        # The bump re-parses the tiers; the device cache catches up on refresh.
        mgr.ps.get_embedding_cache("wdl", 0).refresh(fraction=1.0)
        np.testing.assert_allclose(infer(), 3.0 * expected_vector(keys, 16), rtol=1e-5)
        write_sparse_model(tmp_path / "wdl" / "5" / "sparse0.model", tbl.keys,
                           tbl.vectors * 5.0)
        mgr.unload("wdl")
        mgr.load("wdl", version=5)
        np.testing.assert_allclose(infer(), 5.0 * expected_vector(keys, 16), rtol=1e-5)
    finally:
        mgr.shutdown()


def test_serve_cli_flag_and_http(tmp_path):
    """``serve(model_repository=...)`` on the CPU serves the repository's HPS
    model over HTTP, with its version, like the JAX package's."""
    from hugectr_backend_tpu.serving.server import serve as jserve
    from hugectr_backend_tpu_torch.serving.server import serve

    tbl = _make_repo(tmp_path, versions=(1, 3))
    keys = tbl.keys[:6].astype(np.int64)
    body = json.dumps({"inputs": [
        {"name": "KEYS", "datatype": "INT64", "shape": [6], "data": keys.tolist()},
        {"name": "NUMKEYS", "datatype": "INT32", "shape": [1], "data": [6]},
    ]}).encode()
    got = []
    for srv in (jserve(model_repository=tmp_path, port=0, block=False),
                serve(model_repository=tmp_path, port=0, block=False, device="cpu")):
        try:
            base = f"http://127.0.0.1:{srv.port}"
            with urllib.request.urlopen(urllib.request.Request(
                    f"{base}/v2/repository/index", data=b""), timeout=TIMEOUT) as r:
                index = json.loads(r.read())
            with urllib.request.urlopen(urllib.request.Request(
                    f"{base}/v2/models/wdl/infer", data=body), timeout=TIMEOUT) as r:
                got.append((index, r.read()))
        finally:
            srv.stop()
    assert got[1] == got[0]
    assert got[1][0][0]["version"] == "3"


def test_params_stay_dataclasses(tmp_path):
    """The repository's extra fields ride on the params object, which stays a
    dataclass (``dataclasses.replace`` and equality keep working)."""
    _make_repo(tmp_path)
    p = trepo.load_model_repository(tmp_path, device="cpu")[0].models["wdl"]
    assert dataclasses.is_dataclass(p) and p.repo_model_dir == str(tmp_path / "wdl")
