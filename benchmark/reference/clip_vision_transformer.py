"""OpenAI CLIP's VisionTransformer visual tower, as published in
https://github.com/openai/CLIP/blob/main/clip/model.py (`LayerNorm`, `QuickGELU`,
`ResidualAttentionBlock`, `Transformer`, `VisionTransformer`), in plain PyTorch and
float32.

Parameter names are the release's `visual.*` keys (prefix stripped): `conv1`,
`class_embedding`, `positional_embedding`, `ln_pre`,
`transformer.resblocks.{i}.{ln_1, attn.in_proj_weight, attn.in_proj_bias,
attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}`, `ln_post`, `proj`; so the state dict of
this module is what `FrozenEncoder.load_torch_state_dict` takes. Attention is written
out, softmax(q kᵀ / √d) v per head, where the release calls `nn.MultiheadAttention`
with the same fused in-projection; tokens are batch first, where the release permutes
to (tokens, batch, width) around the transformer.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F


class Attention(nn.Module):
    """Multi-head self-attention with the fused q-k-v in-projection of
    `nn.MultiheadAttention` (its parameter names and q, k, v row order)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x):
        n, t, c = x.shape
        d = c // self.heads
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        q, k, v = (y.reshape(n, t, self.heads, d).transpose(1, 2) for y in (q, k, v))
        attn = (q @ k.transpose(-1, -2) / d ** 0.5).softmax(dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(n, t, c)
        return self.out_proj(out)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block: x + attn(ln_1(x)), then x + c_proj(QuickGELU(c_fc(ln_2(x))))."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width)
        self.attn = Attention(width, heads)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(width, 4 * width)),
            ("c_proj", nn.Linear(4 * width, width)),
        ]))

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        y = self.mlp.c_fc(self.ln_2(x))
        return x + self.mlp.c_proj(y * torch.sigmoid(1.702 * y))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.Sequential(*[ResidualAttentionBlock(width, heads)
                                         for _ in range(layers)])

    def forward(self, x):
        return self.resblocks(x)


class VisionTransformer(nn.Module):
    """Patch embed (a stride-P conv without bias), [class token; patches] + positional
    embedding, ln_pre, the transformer, ln_post of the class token, projection."""

    def __init__(self, input_resolution: int, patch_size: int, width: int, layers: int,
                 heads: int, output_dim: int):
        super().__init__()
        grid = (input_resolution // patch_size) ** 2
        self.conv1 = nn.Conv2d(3, width, patch_size, stride=patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(grid + 1, width))
        self.ln_pre = nn.LayerNorm(width)
        self.transformer = Transformer(width, layers, heads)
        self.ln_post = nn.LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, output_dim))

    def features(self, x):
        """NCHW float image -> {clip_embed: (N, output_dim)}."""
        x = self.conv1(x).flatten(2).transpose(1, 2)              # (N, grid, width)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.transformer(self.ln_pre(x))
        return {"clip_embed": self.ln_post(x[:, 0]) @ self.proj}


def build(config: dict) -> nn.Module:
    """The reference module of a configuration file's `model` section (uninitialised)."""
    m = config["model"]
    return VisionTransformer(m["image_size"], m["patch_size"], m["width"], m["layers"],
                             m["heads"], m["output_dim"])
