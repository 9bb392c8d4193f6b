"""The int8 trunk (`ops/quantize.quantized_trunk_apply`: the stem's f32 convs, K2, K3,
the stride blocks, K5): the published trunk's work at its declared precisions' peaks
over the device time of the kernels launched inside the span, percent."""


def read(view):
    return view.roofline("int8_trunk")
