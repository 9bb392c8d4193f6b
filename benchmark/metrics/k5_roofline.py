"""K5, the int8 identity blocks of stages 2-4 (span `int8.resblocks`:
`fused_resblocks_int8`, one call a stage): their published work at the int8 peak over
the spans' stream time, percent."""

from benchmark.harness.program_spans import stream_roofline


def read(view):
    return stream_roofline(view, "int8.resblocks", "k5")
