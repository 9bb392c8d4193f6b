"""A run with the timed path broken underneath comes out not correct: once for each
fault a cell can have (`harness/faults.py`: an answer altered where it is produced;
half of the batch left out; for training, a step that returns its state unchanged; on
more than one card, the exchange between cards left out on one rank). The chip check is
skipped: these runs drive the rest of a run on the CPU at a test's size, against the
cells' own limits (a four-card cell as four gloo processes)."""

import json

import pytest

from benchmark.harness.cell import REPO, resolve
from benchmark.harness.faults import FAULTS, applies
from benchmark.harness.runner import run
from benchmark.tests.conftest import SEED

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
CASES = [(c, f) for c in CELLS for f in FAULTS if applies(f, resolve(c))]


def _run(cell):
    result, checks = run(cell, SEED, 0.2, False, "cpu")
    return result["correct"], checks


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_cell, name):
    correct, checks = _run(tiny_cell(name))
    assert correct, checks


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(tiny_cell, name, fault):
    cell = tiny_cell(name)
    with FAULTS[fault](cell):
        correct, checks = _run(cell)
    assert not correct, checks
    if fault == "unchanged_state":   # nothing moved: every leaf's gap is its whole change
        assert checks["grad_gap"]["value"] == pytest.approx(1.0)
        assert checks["update_gap"]["value"] > 0.5
    if fault == "half_batch" and cell.traffic["driver"] == "encode":
        assert all(c["value"] == float("inf") for c in checks.values())
    if fault == "local_gradient":   # the replicas part; rank 0's own update is sound
        assert checks["rank_param_gap"]["value"] > 0
        assert checks["grad_gap"]["value"] <= checks["grad_gap"]["limit"]
