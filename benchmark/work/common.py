"""Shared counting helpers for the work modules."""

from __future__ import annotations

from collections import defaultdict

from benchmark.reference.preprocess import plan

BYTES = {"int8": 1, "int4": 0.5, "fp8": 1, "bf16": 2, "f16": 2, "f32": 4, "tf32": 4}


class Layer:
    """Accumulates one layer's operations by precision and its bytes."""

    def __init__(self):
        self.ops = defaultdict(float)
        self.bytes = 0.0

    def conv(self, hw_out: int, cin: int, cout: int, k: int, precision: str,
             weight_precision: str = None):
        """A k x k conv at hw_out x hw_out output pixels: MACs and its weights' bytes."""
        self.ops[precision] += 2.0 * hw_out * hw_out * cout * cin * k * k
        self.bytes += cin * cout * k * k * BYTES[weight_precision or precision]

    def dense(self, rows: int, cin: int, cout: int, precision: str, weight_bytes=True):
        self.ops[precision] += 2.0 * rows * cin * cout
        if weight_bytes:
            self.bytes += cin * cout * BYTES[precision]

    def scaled(self, n: int) -> dict:
        """The counts of a batch of n frames, weights counted once."""
        return {"ops": {p: v * n for p, v in self.ops.items()}, "bytes": self.bytes}


def preprocess_work(batch: int, frame_hw, size: int, out_precision: str) -> dict:
    """Uint8 frames in, the normalised size x size image out; operations of the two
    separable passes (each output sums its nonzero taps) and the normalisation."""
    h, w = frame_hw
    wh, ww = plan(h, w, size)
    taps_w = float((ww != 0).sum())  # over the size output columns
    taps_h = float((wh != 0).sum())
    ops = 2.0 * 3 * (h * taps_w + size * taps_h) + 2.0 * 3 * size * size
    return {"ops": {"f32": batch * ops},
            "bytes": batch * (h * w * 3 + size * size * 3 * BYTES[out_precision])}


def merge(*layers: dict) -> dict:
    ops = defaultdict(float)
    for layer in layers:
        for p, v in layer["ops"].items():
            ops[p] += v
    return {"ops": dict(ops), "bytes": sum(layer["bytes"] for layer in layers)}
