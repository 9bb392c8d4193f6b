"""A cell on four cards, run as four gloo processes on the CPU (`harness/ranks.py`): one
result that reports every rank; a rank that raises, is killed or hangs in the window
ends every rank, with a non-zero exit and no result line, within the traffic's timeout
(`rank_timeout_s`); and a rank other than 0 that loads JAX leaves the run with no
result."""

import json
import os
import re
import subprocess
import sys
import time

import pytest

from benchmark.harness.cell import REPO
from benchmark.harness.runner import run
from benchmark.tests.conftest import SEED

CELL = next(w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]
            if w["chips"] > 1)
UNIT_TIMEOUT_S = 10

FAILING = """
import sys
sys.path.insert(0, {repo!r})
from benchmark.harness.faults import FAILURES
from benchmark.run import finish
from benchmark.tests.conftest import SEED, tiny
cell = tiny({cell!r})
cell.traffic["rank_timeout_s"] = dict(cell.traffic["rank_timeout_s"], unit={unit})
with FAILURES[{failure!r}](cell):
    sys.exit(finish(cell, SEED, {seconds}, False, "cpu"))
"""


def _failing(failure: str, seconds: float):
    return subprocess.run([sys.executable, "-c", FAILING.format(
        repo=str(REPO), cell=CELL, unit=UNIT_TIMEOUT_S, failure=failure, seconds=seconds)],
        cwd=REPO, capture_output=True, text=True, timeout=240)


def test_four_ranks_give_one_result_that_reports_every_rank(tiny_cell):
    result, checks = run(tiny_cell(CELL), SEED, 0.2, False, "cpu")
    assert result["correct"], checks
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device"]
    assert result["device"]["count"] == 4
    assert len(result["device"]["memory_peak_bytes_by_rank"]) == 4
    assert checks["rank_param_gap"]["value"] == 0
    assert set(result["metrics"]) == {"env_steps_per_s", "setup_s"}


def _gone(pid: int, wait_s: float = 10.0) -> bool:
    end = time.monotonic() + wait_s
    while os.path.exists(f"/proc/{pid}"):
        if time.monotonic() > end:
            return False
        time.sleep(0.1)
    return True


@pytest.mark.parametrize("failure", ["rank_raises", "rank_killed", "rank_hangs"])
def test_a_failing_rank_ends_every_rank_with_no_result(failure):
    t0 = time.monotonic()
    proc = _failing(failure, 30.0)
    took = time.monotonic() - t0
    assert proc.returncode != 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == ""
    pids = [int(p) for p in re.findall(r"host: pid (\d+)", proc.stderr)]
    assert len(pids) == 4, proc.stderr[-3000:]
    assert all(_gone(p) for p in pids)
    # The 30-second window never ran out: the failure ended the run, a hang within
    # the unit timeout.
    assert "[bench] window" not in proc.stderr
    if failure == "rank_hangs":
        assert "outlasted its timeout" in proc.stderr
    assert took < 120


def test_a_rank_that_loads_jax_gives_no_result():
    proc = _failing("rank_loads_jax", 5.0)
    assert proc.returncode != 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == ""
    # The last rank loaded it; rank 0 alone would not have seen it.
    assert "[rank 3] [bench] the run loaded jax: no result" in proc.stderr, \
        proc.stderr[-3000:]
    pids = [int(p) for p in re.findall(r"host: pid (\d+)", proc.stderr)]
    assert all(_gone(p) for p in pids)
