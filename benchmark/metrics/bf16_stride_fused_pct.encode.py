"""The share of the bf16 trunk's stride-2 blocks that ran on the hand-written launches:
the blocks on the plan's `stride` step (counter `bf16.stride_fused` of
`models/stages.py`) over every stride-2 block of the folded bf16 trunk
(`bf16.stride_blocks`), percent. A program without the counters reads nothing."""

from benchmark.harness.program_spans import counter_pct


def read(view):
    return counter_pct("bf16.stride_fused", "bf16.stride_blocks")
