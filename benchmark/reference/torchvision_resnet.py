"""torchvision's ResNet (v1.5: the stride on the 3x3 conv), as published in
https://github.com/pytorch/vision/blob/main/torchvision/models/resnet.py, in plain
PyTorch and float32, truncated before its average pool and `fc` as the reference
repository truncates it. Parameter names are torchvision's."""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * self.expansion, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * self.expansion)
        self.downsample = None
        if stride != 1 or inplanes != planes * self.expansion:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes * self.expansion, 1, stride=stride, bias=False),
                nn.BatchNorm2d(planes * self.expansion))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNet(nn.Module):
    def __init__(self, layers, width: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self._inplanes = width
        self.layer1 = self._make_layer(width, layers[0])
        self.layer2 = self._make_layer(width * 2, layers[1], stride=2)
        self.layer3 = self._make_layer(width * 4, layers[2], stride=2)
        self.layer4 = self._make_layer(width * 8, layers[3], stride=2)

    def _make_layer(self, planes, blocks, stride=1):
        layers = [Bottleneck(self._inplanes, planes, stride)]
        self._inplanes = planes * Bottleneck.expansion
        layers += [Bottleneck(self._inplanes, planes) for _ in range(1, blocks)]
        return nn.Sequential(*layers)

    def features(self, x):
        """NCHW float image -> {imagenet_conv (NHWC), imagenet_avgpool}."""
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        conv = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return {"imagenet_conv": conv.permute(0, 2, 3, 1),
                "imagenet_avgpool": conv.mean(dim=(2, 3))}


def build(config: dict) -> nn.Module:
    m = config["model"]
    return ResNet(m["stage_sizes"], m["width"])
