"""``BENCHMARK.json`` and the files it names, found by name."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict        # configs/<config>.json
    mix: dict        # traffic/<traffic>.json
    limits: dict     # limits/<config>.json
    end_to_end: list  # [{"name", "unit", ...}] this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(cell_name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = _json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in {bench_path} (have {sorted(cells)})")
    w = cells[cell_name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = _json(ROOT / configs[w["config"]]["file"])
    return Cell(
        name=cell_name, chips=int(w["chips"]), cfg=cfg,
        mix=_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_json(HERE / "limits" / f"{w['config']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, cell_name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, cell_name)],
    )


def peaks(kind: str):
    """The card's published peaks (``peaks.json``), or None for a card not
    listed there."""
    return _json(HERE / "peaks.json").get(kind)
