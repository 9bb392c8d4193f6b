"""Each cell's control, the configuration's `control` section (the program's own path
one precision below: int4 stage 1 for the int8 trunk, the int8 graph for the bf16
trunk) and, for training, the reference in bfloat16 products in the program's place,
comes out not correct against the cell's own limits, while the program does not.
At a test's size on the CPU; `benchmark/limits.py` reads both on the card at the
cells' sizes (PERF.md gives those readings)."""

import json

import pytest

from benchmark.harness.cell import REPO
from benchmark.harness.runner import run
from benchmark.tests.conftest import SEED

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_program_passes(tiny_cell, name):
    sound, _ = run(tiny_cell(name), SEED, 0.2, False, "cpu")
    control, checks = run(tiny_cell(name), SEED, 0.2, False, "cpu", control=True)
    assert sound["correct"] and not control["correct"], checks
