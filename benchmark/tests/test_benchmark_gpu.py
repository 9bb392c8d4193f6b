"""Each cell end to end on the card, as the benchmark's command runs it (short window):
`python -m pytest benchmark/tests/test_benchmark_gpu.py -m gpu` on a machine with a
CUDA card. Skips without one."""

import json
import subprocess
import sys

import pytest

from benchmark.harness.cell import REPO

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_card(name, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name,
                           "--seed", str(2 ** 31 + 17), "--seconds", "2", "--trace",
                           str(trace)], cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
