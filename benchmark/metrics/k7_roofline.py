"""K7, the bf16 stage 1 (span `bf16.stage1` of `models/stages.py`: `fused_stage1`): the
published stage's work at the bf16 peak over the span's stream time, percent."""

from benchmark.harness.program_spans import stream_roofline


def read(view):
    return stream_roofline(view, "bf16.stage1", "k7")
