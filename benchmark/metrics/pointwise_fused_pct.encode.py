"""The share of the ViT blocks' per-element work on the one-pass launches: the elements
of the LayerNorms and QuickGELUs that went through them (counter `pw.fused_elements`)
over all those the tower computed (`pw.elements`), percent. A program without the
counters reads nothing."""

from benchmark.harness.program_spans import counter_pct


def read(view):
    return counter_pct("pw.fused_elements", "pw.elements")
