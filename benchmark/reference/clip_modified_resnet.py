"""OpenAI CLIP's ModifiedResNet visual tower with its attention pool, as published in
https://github.com/openai/CLIP/blob/main/clip/model.py (`Bottleneck`, `AttentionPool2d`,
`ModifiedResNet`), in plain PyTorch and float32.

Parameter names are the release's `visual.*` keys (prefix stripped), so the state dict
of this module is what `FrozenEncoder.load_torch_state_dict` takes. `features` returns
the three views the reference repository caches: the NHWC conv map, its spatial mean,
and the attention-pool embedding.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        # Every conv has stride 1; a stride > 1 is an avgpool after the second conv.
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.avgpool = nn.AvgPool2d(stride) if stride > 1 else nn.Identity()
        self.conv3 = nn.Conv2d(planes, planes * self.expansion, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * self.expansion)
        self.downsample = None
        if stride > 1 or inplanes != planes * self.expansion:
            self.downsample = nn.Sequential(OrderedDict([
                ("-1", nn.AvgPool2d(stride)),
                ("0", nn.Conv2d(inplanes, planes * self.expansion, 1, stride=1,
                                bias=False)),
                ("1", nn.BatchNorm2d(planes * self.expansion)),
            ]))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.avgpool(out)
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """Multi-head attention of the mean token over [mean, cells] + positional
    embedding; the output of the mean token, projected by `c_proj`."""

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int, output_dim: int):
        super().__init__()
        self.positional_embedding = nn.Parameter(torch.empty(spacial_dim ** 2 + 1, embed_dim))
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.c_proj = nn.Linear(embed_dim, output_dim)
        self.num_heads = num_heads

    def forward(self, x):
        x = x.flatten(start_dim=2).permute(2, 0, 1)  # NCHW -> (HW)NC
        x = torch.cat([x.mean(dim=0, keepdim=True), x], dim=0)
        x = x + self.positional_embedding[:, None, :]
        t, n, c = x.shape
        h, e = self.num_heads, c // self.num_heads
        q = F.linear(x[:1], self.q_proj.weight, self.q_proj.bias) * e ** -0.5
        k = F.linear(x, self.k_proj.weight, self.k_proj.bias)
        v = F.linear(x, self.v_proj.weight, self.v_proj.bias)
        q = q.reshape(1, n, h, e).permute(1, 2, 0, 3)   # (N, H, 1, E)
        k = k.reshape(t, n, h, e).permute(1, 2, 0, 3)   # (N, H, T, E)
        v = v.reshape(t, n, h, e).permute(1, 2, 0, 3)
        attn = (q @ k.transpose(-1, -2)).softmax(dim=-1)
        out = (attn @ v)[:, :, 0].reshape(n, c)
        return F.linear(out, self.c_proj.weight, self.c_proj.bias)


class ModifiedResNet(nn.Module):
    """3-conv stem with an average pool, four bottleneck stages, attention pool."""

    def __init__(self, layers, output_dim: int, heads: int, input_resolution: int = 224,
                 width: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, width // 2, 3, stride=2, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(width // 2)
        self.conv2 = nn.Conv2d(width // 2, width // 2, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(width // 2)
        self.conv3 = nn.Conv2d(width // 2, width, 3, padding=1, bias=False)
        self.bn3 = nn.BatchNorm2d(width)
        self.avgpool = nn.AvgPool2d(2)
        self._inplanes = width
        self.layer1 = self._make_layer(width, layers[0])
        self.layer2 = self._make_layer(width * 2, layers[1], stride=2)
        self.layer3 = self._make_layer(width * 4, layers[2], stride=2)
        self.layer4 = self._make_layer(width * 8, layers[3], stride=2)
        embed_dim = width * 32
        self.attnpool = AttentionPool2d(input_resolution // 32, embed_dim, heads, output_dim)

    def _make_layer(self, planes, blocks, stride=1):
        layers = [Bottleneck(self._inplanes, planes, stride)]
        self._inplanes = planes * Bottleneck.expansion
        layers += [Bottleneck(self._inplanes, planes) for _ in range(1, blocks)]
        return nn.Sequential(*layers)

    def trunk(self, x):
        """NCHW float image -> NCHW conv map."""
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = self.avgpool(x)
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))

    def features(self, x):
        """NCHW float image -> {clip_conv (NHWC), clip_avgpool, clip_attnpool}."""
        conv = self.trunk(x)
        return {"clip_conv": conv.permute(0, 2, 3, 1), "clip_avgpool": conv.mean(dim=(2, 3)),
                "clip_attnpool": self.attnpool(conv)}


def build(config: dict) -> nn.Module:
    """The reference module of a configuration file's `model` section (uninitialised)."""
    m = config["model"]
    return ModifiedResNet(m["stage_sizes"], m["output_dim"], m["heads"], m["image_size"],
                          m["width"])
