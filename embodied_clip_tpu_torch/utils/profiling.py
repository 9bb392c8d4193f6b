"""Tracing and profiling (port of `embodied_clip_tpu/utils/profiling.py`).

`StageTimer` gives per-stage wall-time accounting for the RL loop's hot stages (act /
env_step / update) as first-class trainer metrics; `trace` wraps `torch.profiler` for
an on-demand device trace of a block, written for TensorBoard's profiler plugin or
Perfetto.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

__all__ = ["StageTimer", "trace"]


class StageTimer:
    """Accumulates wall time per named stage; `summary()` returns seconds and shares."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        total = sum(self.totals.values()) or 1.0
        out: Dict[str, float] = {}
        for name, secs in self.totals.items():
            out[f"{name}_s"] = secs
            out[f"{name}_frac"] = secs / total
            out[f"{name}_calls"] = float(self.counts[name])
        return out

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a `torch.profiler` trace (host, and the card's kernels where there is
    one) of the enclosed block into `log_dir`. Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)
                 ) as prof:
        yield prof
