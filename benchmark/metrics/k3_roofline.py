"""K3, the int8 stage 1 (span `int8.stage1`: `fused_stage1_int8`, three bottlenecks and
the bf16 conv shortcut): the published stage's work at its declared precisions' peaks
over the span's stream time, percent."""

from benchmark.harness.program_spans import stream_roofline


def read(view):
    return stream_roofline(view, "int8.stage1", "k3")
