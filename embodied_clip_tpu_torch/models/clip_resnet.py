"""CLIP's modified ResNet visual encoder with attention pooling (port of
`embodied_clip_tpu/models/clip_resnet.py`).

Architecture (vs torchvision ResNet): 3-conv stem with a 2x2 average pool (no
maxpool), average-pool "anti-aliased" downsampling inside bottlenecks and shortcuts,
and a multi-head attention pool instead of global average pooling.

Module and parameter names are openai/CLIP's (`conv1`/`bn1` … `layerS.B.conv1` …
`downsample.0`/`.1`, `attnpool.{q,k,v,c}_proj`), so a real checkpoint loads with
`load_state_dict`. The public layout is the JAX package's NHWC; inside, convs run on
channels-last tensors. BN runs in f32 under a bf16 trunk; `folded=True` trunks carry
conv biases and no BN (ops/fold_bn.py). A folded bf16 trunk runs stage 1 through kernel
K7 and its stride-1 identity blocks through K6 (models/stages.py).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from embodied_clip_tpu_torch.models.stages import StagesMixin
from embodied_clip_tpu_torch.utils.profiling import span

__all__ = ["ModifiedResNet", "AttentionPool2d", "CLIPBottleneck", "CLIP_RESNET_CONFIGS"]


def _conv(cin: int, cout: int, k: int, stride: int, dtype, folded: bool) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=folded,
                     dtype=dtype)


def _bn(c: int, folded: bool) -> Optional[nn.BatchNorm2d]:
    return None if folded else nn.BatchNorm2d(c)


def _conv_bn(x: torch.Tensor, conv: nn.Conv2d, bn: Optional[nn.BatchNorm2d]):
    """Conv in the compute dtype, then (unfolded) frozen BN in f32, cast back."""
    y = F.conv2d(x, conv.weight, conv.bias, conv.stride, conv.padding)
    if bn is None:
        return y
    return F.batch_norm(y.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                        False, 0.0, bn.eps).to(y.dtype)


class CLIPBottleneck(nn.Module):
    """Bottleneck where all convs are stride-1; downsampling is an explicit avg-pool
    before conv3 and in the shortcut (CLIP's anti-aliased design)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype=torch.float32, folded: bool = False):
        super().__init__()
        out = planes * self.expansion
        self.stride = stride
        self.conv1 = _conv(inplanes, planes, 1, 1, dtype, folded)
        self.bn1 = _bn(planes, folded)
        self.conv2 = _conv(planes, planes, 3, 1, dtype, folded)
        self.bn2 = _bn(planes, folded)
        self.conv3 = _conv(planes, out, 1, 1, dtype, folded)
        self.bn3 = _bn(out, folded)
        self.downsample = None
        if stride > 1 or inplanes != out:
            layers = OrderedDict([
                ("-1", nn.AvgPool2d(stride) if stride > 1 else nn.Identity()),
                ("0", _conv(inplanes, out, 1, 1, dtype, folded)),
            ])
            if not folded:
                layers["1"] = nn.BatchNorm2d(out)
            self.downsample = nn.Sequential(layers)

    def forward(self, x):
        out = F.relu(_conv_bn(x, self.conv1, self.bn1))
        out = F.relu(_conv_bn(out, self.conv2, self.bn2))
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = _conv_bn(out, self.conv3, self.bn3)
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = _conv_bn(identity, getattr(self.downsample, "0"),
                                getattr(self.downsample, "1", None))
        return F.relu(out + identity)


class ModifiedResNet(StagesMixin, nn.Module):
    """Trunk: 3-conv stem + avgpool, 4 bottleneck stages. NHWC in, NHWC conv map out
    (N,7,7,2048 for RN50 at 224px)."""

    def __init__(self, stage_sizes: Sequence[int], width: int = 64,
                 dtype=torch.float32, folded: bool = False):
        super().__init__()
        self._init_stages()
        self.dtype = dtype
        self.folded = folded
        self.conv1 = _conv(3, width // 2, 3, 2, dtype, folded)
        self.bn1 = _bn(width // 2, folded)
        self.conv2 = _conv(width // 2, width // 2, 3, 1, dtype, folded)
        self.bn2 = _bn(width // 2, folded)
        self.conv3 = _conv(width // 2, width, 3, 1, dtype, folded)
        self.bn3 = _bn(width, folded)
        self.avgpool = nn.AvgPool2d(2)
        inp = width
        for stage, n_blocks in enumerate(stage_sizes):
            planes = width * (2 ** stage)
            blocks = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage > 0) else 1
                blocks.append(CLIPBottleneck(inp, planes, stride, dtype, folded))
                inp = planes * CLIPBottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        self.embed_dim = inp

    def forward(self, x):
        # NHWC → an NCHW view whose memory is channels-last: no copy for NHWC input.
        with span("bf16.stem"):
            x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            x = F.relu(_conv_bn(x, self.conv1, self.bn1))
            x = F.relu(_conv_bn(x, self.conv2, self.bn2))
            x = self.avgpool(F.relu(_conv_bn(x, self.conv3, self.bn3)))
        return self.run_stages(x)


class AttentionPool2d(nn.Module):
    """CLIP's attention pooling over the NHWC conv map.

    Tokens = [mean, h×w cells] + learned positional embedding; one multi-head
    attention where only the mean token queries (identical to querying all tokens and
    keeping token 0). The K/V projections of the tokens are never materialised; the
    matmuls are reassociated around the single query:
      logits[n,h,j] = Σ_d x̃[n,j,d]·U[n,h,d],  U = q·W_kᵀ (per head)
      out = ((Σ_j attn[n,h,j]·x̃[n,j])·W_v + b_v)·W_c + b_c
    The k bias is constant over j → softmax-invariant → unused. Precision islands:
    logits, softmax, the pooled sums and c_proj run in f32; the rest in the compute
    dtype.
    """

    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int, dtype=torch.float32):
        super().__init__()
        self.positional_embedding = nn.Parameter(
            torch.empty(spacial_dim ** 2 + 1, embed_dim, dtype=dtype))
        self.q_proj = nn.Linear(embed_dim, embed_dim, dtype=dtype)
        self.k_proj = nn.Linear(embed_dim, embed_dim, dtype=dtype)
        self.v_proj = nn.Linear(embed_dim, embed_dim, dtype=dtype)
        self.c_proj = nn.Linear(embed_dim, output_dim)  # f32 precision island
        self.num_heads = num_heads

    def forward(self, x):
        n, h, w, c = x.shape
        dt, f32 = x.dtype, torch.float32
        heads = self.num_heads
        e = c // heads
        tokens = x.reshape(n, h * w, c)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(dt)
        q = F.linear(tokens[:, 0], self.q_proj.weight, self.q_proj.bias)
        q = (q / (e ** 0.5)).reshape(n, heads, e)
        u = torch.einsum("nhe,hed->nhd", q, self.k_proj.weight.reshape(heads, e, c))
        tokens32 = tokens.to(f32)
        logits = torch.einsum("njd,nhd->nhj", tokens32, u.to(f32))
        attn = logits.softmax(dim=-1)
        pooled = torch.einsum("nhj,njd->nhd", attn.to(dt).to(f32), tokens32)
        vh = torch.einsum("nhd,hed->nhe", pooled.to(dt).to(f32),
                          self.v_proj.weight.to(f32).reshape(heads, e, c))
        vh = vh + self.v_proj.bias.to(f32).reshape(heads, e)
        out = F.linear(vh.reshape(n, c), self.c_proj.weight, self.c_proj.bias)
        return out.to(dt)


CLIP_RESNET_CONFIGS = {
    # name: (stage_sizes, width, embed_dim=width*32, heads, output_dim, image_size)
    "RN50": dict(stage_sizes=(3, 4, 6, 3), width=64, num_heads=32, output_dim=1024, image_size=224),
    "RN50x16": dict(stage_sizes=(6, 8, 18, 8), width=96, num_heads=48, output_dim=768, image_size=384),
    # Smoke-scale config: exercises the full ModifiedResNet code path (stem, 4
    # stages, attnpool) at CPU-test cost. Not a reference model.
    "RNtiny": dict(stage_sizes=(1, 1, 1, 1), width=8, num_heads=4, output_dim=16, image_size=128),
}
