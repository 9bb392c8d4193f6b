"""K6, the bf16 identity bottlenecks of stages 2-4 (span `bf16.bottleneck` of
`models/stages.py`: `fused_bottleneck`, one call a block): their published work at the
bf16 peak over the spans' stream time, percent."""

from benchmark.harness.program_spans import stream_roofline


def read(view):
    return stream_roofline(view, "bf16.bottleneck", "k6")
