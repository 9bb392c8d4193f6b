"""A cell resolved from its files by name: `BENCHMARK.json` names the cell's
configuration and traffic mix, and everything else is found by name under
`benchmark/`: `configs/<config>.json`, `traffic/<mix>.json`, `limits/<cell>.json`,
every `layers/<layer>.json`, `metrics/<metric>.py` for each per-layer metric, and the
driver (`drivers/<driver>.py`), reference (`reference/<family>.py`) and work counts
(`work/<family>.py`) that the configuration and the traffic name. The harness holds no
code of its own for any cell."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]   # benchmark/
REPO = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    layers: Dict[str, dict]
    chips: int = 1
    faults: List[str] = dataclasses.field(default_factory=list)   # planted (harness/faults.py)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_layers() -> Dict[str, dict]:
    return {p.stem: _json(p) for p in sorted((HERE / "layers").glob("*.json"))}


def resolve(name: str, bench_path: Path = REPO / "BENCHMARK.json") -> Cell:
    bench = _json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path.name}: {sorted(cells)}")
    w = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(name=name, config=_json(REPO / cfg["file"]),
                traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=_json(HERE / "limits" / f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
                layers=load_layers(), chips=w["chips"])


def module(kind: str, name: str):
    """`benchmark/<kind>/<name>.py` as a module (drivers, references, work counts)."""
    return importlib.import_module(f"benchmark.{kind}.{name}")


def metric_reader(name: str):
    """The `read(view)` function of `metrics/<name>.py` (names may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
