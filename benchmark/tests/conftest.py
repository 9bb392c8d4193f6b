"""Shared fixtures of the benchmark's CPU tests: cells resolved from the repository's
files, cut to a size a CPU test run holds (the port's `clip_rn_tiny` or `clip_vit_tiny`
encoder, a few small frames, a short window; a cell on four cards as four gloo
processes of one thread, two envs each). Run: `python -m pytest benchmark/tests -q`."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_MODEL = {"stage_sizes": [1, 1, 1, 1], "width": 8, "heads": 4, "output_dim": 16,
              "image_size": 128}
VIT_TINY = {"patch_size": 16, "width": 32, "layers": 2, "heads": 4, "output_dim": 16,
            "image_size": 64}   # the port's `clip_vit_tiny`
SEED = 2 ** 31 + 4242
RANK_TIMEOUT_S = {"setup": 300, "unit": 60, "judge": 120}


def tiny(name: str):
    """The cell `name`, resolved from its files, at a CPU test's size."""
    import torch

    from benchmark.harness.cell import resolve

    torch.set_num_threads(4)
    cell = resolve(name)
    cfg = dict(cell.config, calibration_frames=4, calibration_hw=[60, 60])
    if cfg["program"]["encoder"].startswith("clip_vit"):
        cfg["model"] = VIT_TINY
        cfg["program"] = dict(cfg["program"], encoder="clip_vit_tiny")
    elif cfg["program"]["encoder"].startswith("clip"):
        cfg["model"] = TINY_MODEL
        cfg["program"] = dict(cfg["program"], encoder="clip_rn_tiny")
    cell.config = cfg
    if cell.traffic["driver"] == "encode":
        cell.traffic = dict(cell.traffic, batch=4, pool=2, frame_hw=[60, 60],
                            warmup_units=1, trace_skip=1, trace_units=2)
    elif cell.chips > 1:
        cell.traffic = dict(cell.traffic, env_batch=2 * cell.chips, rollout_len=8, hidden=32,
                            trace_skip=1, trace_units=1, host_threads=1,
                            rank_timeout_s=RANK_TIMEOUT_S)
    else:
        cell.traffic = dict(cell.traffic, env_batch=4, rollout_len=8, hidden=32,
                            trace_skip=1, trace_units=1)
    return cell


@pytest.fixture
def tiny_cell():
    return tiny
