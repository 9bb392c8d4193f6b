"""The bf16 stride blocks (span `bf16.block` of `models/stages.py`: block 0 of stages
2-4, the block's own forward on cuDNN with its separate add and ReLU): their published
work at the bf16 peak over the spans' stream time, percent."""

from benchmark.harness.program_spans import stream_roofline


def read(view):
    return stream_roofline(view, "bf16.block", "bf16_stride_blocks")
