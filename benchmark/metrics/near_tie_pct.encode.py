"""The stride shortcut's near-ties: the share of its output elements that the launch
flagged and summed again exactly (counters `sb.near_tie_elements` over
`sb.shortcut_elements` of `fused_stride_block_int8`), percent."""

from benchmark.harness.program_spans import counter_pct


def read(view):
    return counter_pct("sb.near_tie_elements", "sb.shortcut_elements")
