"""Every configuration, traffic mix, limit and reader that BENCHMARK.json
names loads by name, and the file keeps to the benchmark's contract."""

import importlib
import json
import re

from hpsbench import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_loads_by_name():
    for w in BENCH["workloads"]:
        cell = spec.load(w["name"])
        assert cell.cfg["name"] == w["config"]
        assert cell.mix["loop"] in ("open", "closed")
        assert "failed_requests" in cell.limits
        importlib.import_module(f"hpsbench.deploy.{cell.cfg['kind']}")
        importlib.import_module(f"hpsbench.reference.{cell.cfg['kind']}")
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names


def test_every_per_layer_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        mod = importlib.import_module(f"hpsbench.metrics.{m['name'].split('.')[0]}")
        assert callable(mod.read)


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and len(c["source"]) <= 200
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg and not k.endswith(("_dim", "_rank"))
            assert cfg[k] != cfg.get("published_" + k)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert len(json.dumps(BENCH)) < 64 * 1024
