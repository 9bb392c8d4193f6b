"""The int8 stem (span `int8.stem` of `ops/quantize.quantized_trunk_apply`: stem1 and
stem2, f32 cuDNN convs, and stem3 with its requant and pool, K2): the published stem's
work at its declared precisions' peaks over the span's stream time, percent."""

from benchmark.harness.program_spans import stream_roofline


def read(view):
    return stream_roofline(view, "int8.stem", "int8_stem")
