"""The int8 stride blocks (span `int8.stride_block`: `fused_stride_block_int8`, block 0
of stages 2-4 with its bf16 conv shortcut): their published work at the declared
precisions' peaks over the spans' stream time, percent."""

from benchmark.harness.program_spans import stream_roofline


def read(view):
    return stream_roofline(view, "int8.stride_block", "stride_blocks")
