"""The bf16 trunk (`models/resnet.ResNet.forward`, `ModifiedResNet.forward`: K7, K6 and
the cuDNN stem and stride-2 blocks): the published trunk's work at the bf16 peak over
the device time of the kernels launched inside the span, percent."""


def read(view):
    return view.roofline("bf16_trunk")
