"""Each cell resolves from its files by name, and BENCHMARK.json keeps the rules its
readers rely on."""

import json
import re

import pytest

from benchmark.harness.cell import HERE, REPO, metric_reader, module, resolve

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
EXACT = {"rank_param_gap"}   # replicas after an NCCL all-reduce are bit-equal


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_from_its_files(name):
    cell = resolve(name)
    driver = module("drivers", cell.traffic["driver"])
    assert hasattr(driver, "Driver")
    module("reference", cell.config["reference"])
    # Every limit is positive but an exact comparison's, which is 0.
    assert cell.limits and all(v > 0 or k in EXACT for k, v in cell.limits.items())
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    e2e = {m["name"] for m in cell.end_to_end}
    for m in cell.per_layer:
        assert callable(metric_reader(m["name"]))
        assert m["moves"] in e2e
    for key in cell.layers:
        for target in cell.layers[key]["spans"]:
            assert ":" in target and target.startswith("embodied_clip_tpu_torch.")


def test_benchmark_json_rules():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert (REPO / c["file"]).is_file() and c["file"].startswith("benchmark/")
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and "\t" not in m["layer"]
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
        if m["name"].endswith("_roofline") or "mfu" in m["name"].split("."):
            assert m["unit"] == "%"
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
