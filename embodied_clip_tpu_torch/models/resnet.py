"""ImageNet ResNets, torchvision-weight-compatible (port of
`embodied_clip_tpu/models/resnet.py`).

The reference's `torchvision.models.resnet{18,50}` truncated before avgpool/fc: the
forward returns the final conv map (N,7,7,2048 for ResNet-50 at 224 px); the pooled
head lives in `encoders.py`. Module and parameter names are torchvision's (`conv1`/`bn1`,
`layerS.B.convK`/`bnK`, `downsample.0`/`.1`), so a torchvision state_dict without its
`fc.*` loads with `load_state_dict`. NHWC at the public boundary, channels-last inside;
symmetric padding k//2 for every conv and a 3×3/2 max pool with padding 1, as the JAX
package. BN runs in f32 under a bf16 trunk; `folded=True` trunks carry conv biases and
no BN, and a folded bf16 bottleneck trunk runs layer1 through kernel K7 and its
stride-1 identity blocks through K6 (models/stages.py).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from embodied_clip_tpu_torch.models.clip_resnet import _bn, _conv, _conv_bn
from embodied_clip_tpu_torch.models.stages import StagesMixin
from embodied_clip_tpu_torch.utils.profiling import span

__all__ = ["ResNet", "Bottleneck", "BasicBlock", "RESNET_CONFIGS"]


def _downsample(inplanes: int, out: int, stride: int, dtype, folded: bool):
    layers = [_conv(inplanes, out, 1, stride, dtype, folded)]
    if not folded:
        layers.append(nn.BatchNorm2d(out))
    return nn.Sequential(*layers)


def _shortcut(x: torch.Tensor, downsample) -> torch.Tensor:
    if downsample is None:
        return x
    return _conv_bn(x, downsample[0], downsample[1] if len(downsample) > 1 else None)


class BasicBlock(nn.Module):
    """Two 3×3 convs (ResNet-18/34); the stride is on the first."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype=torch.float32, folded: bool = False):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv(inplanes, planes, 3, stride, dtype, folded)
        self.bn1 = _bn(planes, folded)
        self.conv2 = _conv(planes, planes, 3, 1, dtype, folded)
        self.bn2 = _bn(planes, folded)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = _downsample(inplanes, planes, stride, dtype, folded)

    def forward(self, x):
        out = F.relu(_conv_bn(x, self.conv1, self.bn1))
        out = _conv_bn(out, self.conv2, self.bn2)
        return F.relu(out + _shortcut(x, self.downsample))


class Bottleneck(nn.Module):
    """1×1 → 3×3 (stride) → 1×1 (×4): torchvision's v1.5 stride placement."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype=torch.float32, folded: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.stride = stride
        self.conv1 = _conv(inplanes, planes, 1, 1, dtype, folded)
        self.bn1 = _bn(planes, folded)
        self.conv2 = _conv(planes, planes, 3, stride, dtype, folded)
        self.bn2 = _bn(planes, folded)
        self.conv3 = _conv(planes, out, 1, 1, dtype, folded)
        self.bn3 = _bn(out, folded)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = _downsample(inplanes, out, stride, dtype, folded)

    def forward(self, x):
        out = F.relu(_conv_bn(x, self.conv1, self.bn1))
        out = F.relu(_conv_bn(out, self.conv2, self.bn2))
        out = _conv_bn(out, self.conv3, self.bn3)
        return F.relu(out + _shortcut(x, self.downsample))


class ResNet(StagesMixin, nn.Module):
    """Trunk only: 7×7/2 stem + max pool, 4 stages. NHWC in, NHWC conv map out."""

    def __init__(self, stage_sizes: Sequence[int], block: str = "bottleneck",
                 width: int = 64, dtype=torch.float32, folded: bool = False):
        super().__init__()
        self._init_stages()
        self.dtype = dtype
        self.folded = folded
        self.conv1 = _conv(3, width, 7, 2, dtype, folded)
        self.bn1 = _bn(width, folded)
        cls = Bottleneck if block == "bottleneck" else BasicBlock
        inp = width
        for stage, n_blocks in enumerate(stage_sizes):
            planes = width * (2 ** stage)
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                blocks.append(cls(inp, planes, stride, dtype, folded))
                inp = planes * cls.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        self.out_channels = inp

    def forward(self, x):
        # NHWC → an NCHW view whose memory is channels-last: no copy for NHWC input.
        with span("bf16.stem"):
            x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            x = F.max_pool2d(F.relu(_conv_bn(x, self.conv1, self.bn1)), 3, 2, 1)
        return self.run_stages(x)


RESNET_CONFIGS = {
    "resnet18": dict(stage_sizes=(2, 2, 2, 2), block="basic"),
    "resnet50": dict(stage_sizes=(3, 4, 6, 3), block="bottleneck"),
}
