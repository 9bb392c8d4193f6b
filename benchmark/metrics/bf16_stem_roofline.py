"""The bf16 stem (span `bf16.stem` of `models/resnet.ResNet.forward` and
`models/clip_resnet.ModifiedResNet.forward`: torchvision's 7×7 conv and max pool, or
CLIP's stem1-3 and average pool, on cuDNN): the published stem's work at the bf16 peak
over the spans' stream time, percent."""

from benchmark.harness.program_spans import stream_roofline


def read(view):
    return stream_roofline(view, "bf16.stem", "bf16_stem")
