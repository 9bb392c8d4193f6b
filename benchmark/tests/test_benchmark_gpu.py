"""Each cell end to end on the card, as the benchmark's command runs it (short window):
`python -m pytest benchmark/tests/test_benchmark_gpu.py -m gpu` on a machine with a
CUDA card; a cell on more cards than the machine has skips, as does everything
without a card. On four cards, a rank killed in the window of the four-card cell, at
its own size, ends the run with no result."""

import json
import os
import re
import subprocess
import sys
import time

import pytest

from benchmark.harness.cell import REPO

WORKLOADS = json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]
CELLS = [w["name"] for w in WORKLOADS]
CHIPS = {w["name"]: w["chips"] for w in WORKLOADS}

KILLED = """
import sys
sys.path.insert(0, {repo!r})
from benchmark.harness.cell import resolve
from benchmark.harness.faults import FAILURES
from benchmark.run import finish
cell = resolve({cell!r})
with FAILURES["rank_killed"](cell):
    sys.exit(finish(cell, {seed}, 30.0, False, "cuda"))
"""


def _cards(n: int):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA card(s)")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_card(name, trace):
    _cards(CHIPS[name])
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name,
                           "--seed", str(2 ** 31 + 17), "--seconds", "2", "--trace",
                           str(trace)], cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["device"]["count"] == CHIPS[name]


@pytest.mark.gpu
@pytest.mark.parametrize("name", [c for c in CELLS if CHIPS[c] > 1])
def test_a_killed_rank_ends_the_run_on_cards(name):
    _cards(CHIPS[name])
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-c", KILLED.format(
        repo=str(REPO), cell=name, seed=2 ** 31 + 29)], cwd=REPO, capture_output=True,
        text=True, timeout=900)
    took = time.monotonic() - t0
    print(proc.stderr[-3000:], f"\n[test] ended after {took:.1f} s, exit {proc.returncode}")
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "[bench] window" not in proc.stderr
    for pid in map(int, re.findall(r"host: pid (\d+)", proc.stderr)):
        end = time.monotonic() + 10
        while os.path.exists(f"/proc/{pid}") and time.monotonic() < end:
            time.sleep(0.1)
        assert not os.path.exists(f"/proc/{pid}")
