"""The comparison that decides `correct`.

`cosine_distances` is a frozen copy of `embodied_clip_tpu_torch/parity.py`'s
`cosine_distance` (per sample, the rows flattened, in float64), computed on the device
and returning every sample's distance rather than only the largest.
"""

from __future__ import annotations

import math

import torch


def cosine_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-sample cosine distance of two feature batches, float64."""
    a = a.detach().reshape(a.shape[0], -1).to(torch.float64)
    b = b.detach().reshape(b.shape[0], -1).to(b.device, torch.float64)
    num = (a * b).sum(-1)
    den = a.norm(dim=-1) * b.norm(dim=-1) + 1e-30
    return 1.0 - num / den


def judge(readings: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) of readings held to their limits; a
    reading that is missing, not finite, or over its limit is not correct."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = readings.get(name, math.inf)
        value = math.inf if value is None or not math.isfinite(value) else float(value)
        checks[name] = {"value": value, "limit": limit}
        correct = correct and value <= limit
    return correct, checks
