"""CLIP ViT visual tower, ViT-B/32 of `BASELINE.json`'s model set (port of
`embodied_clip_tpu/models/clip_vit.py`), and ViT-L/14@336px, which the port adds
(openai/CLIP's `_MODELS["ViT-L/14@336px"]`: CLIP's largest released visual tower, the
vision encoder of LLaVA-1.5-style agents).

Patch embed (no bias) → [class token; patches] + positional embedding → ln_pre →
pre-LN transformer → ln_post on the class token → projection into the shared embedding
space. NHWC input, as in the JAX package; openai/CLIP's names (`conv1.weight`,
`class_embedding`, `positional_embedding`, `ln_pre`, `transformer`, `ln_post`, `proj`).

The patch embed is the JAX package's stride-P VALID conv computed as a matmul of the
P×P patches with the (width, P·P·3) weight: the same products, and no cuDNN conv, whose
TF32 default would touch the f32 path. `x + pos` stays in the compute dtype, ln_pre is
cast to it, and ln_post of the class token stays f32 into the f32 projection
(`clip_vit.py:43-48`); ln_pre and the blocks' per-element chains are one launch each
on the card in bf16 (`models/transformer.py`). The forward is three spans inside the
encoder's `encode.trunk`: `vit.embed` (patch embed, class token, positional add,
ln_pre), `vit.blocks` and `vit.head` (ln_post, projection).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from embodied_clip_tpu_torch.models.transformer import (Transformer, layer_norm_cast,
                                                        layer_norm_f32)
from embodied_clip_tpu_torch.utils.profiling import span

__all__ = ["VisionTransformer", "CLIP_VIT_CONFIGS", "patch_embed"]


def patch_embed(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """NHWC images (n, h, w, 3) × an OIHW (width, 3, P, P) weight → (n, grid, width):
    the stride-P VALID conv (trailing rows and columns dropped), in the inputs' dtype."""
    n, h, w, c = x.shape
    width, _, p, _ = weight.shape
    gh, gw = h // p, w // p
    cols = (x[:, :gh * p, :gw * p].reshape(n, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
            .reshape(n * gh * gw, p * p * c))
    w_mat = weight.permute(0, 2, 3, 1).reshape(width, p * p * c)
    return F.linear(cols, w_mat).reshape(n, gh * gw, width)


class VisionTransformer(nn.Module):
    def __init__(self, patch_size: int, width: int, layers: int, num_heads: int,
                 output_dim: int, image_size: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        grid = (image_size // patch_size) ** 2
        self.conv1 = nn.Conv2d(3, width, patch_size, patch_size, bias=False, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.empty(width, dtype=dtype))
        self.positional_embedding = nn.Parameter(torch.empty(grid + 1, width, dtype=dtype))
        self.ln_pre = nn.LayerNorm(width)  # f32
        self.transformer = Transformer(width, layers, num_heads, dtype)
        self.ln_post = nn.LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, output_dim))  # f32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image batch → (n, output_dim) in the compute dtype."""
        with span("vit.embed"):
            x = patch_embed(x.to(self.dtype), self.conv1.weight)
            cls = self.class_embedding.expand(x.shape[0], 1, -1)
            x = torch.cat([cls, x], dim=1) + self.positional_embedding
            x = layer_norm_cast(x, self.ln_pre, self.dtype)
        with span("vit.blocks"):
            x = self.transformer(x)
        with span("vit.head"):
            return torch.matmul(layer_norm_f32(x[:, 0], self.ln_post),
                                self.proj).to(self.dtype)


CLIP_VIT_CONFIGS = {
    "ViT-B/32": dict(patch_size=32, width=768, layers=12, num_heads=12, output_dim=512,
                     image_size=224),
    # The port's own entry (the JAX package lists ViT-B/32 only): 577 tokens of width
    # 1,024, 24 blocks of 16 heads of 64, output 768.
    "ViT-L/14@336px": dict(patch_size=14, width=1024, layers=24, num_heads=16,
                           output_dim=768, image_size=336),
    # Smoke-scale ViT (full code path, CPU-test cost; not a paper model).
    "ViTtiny": dict(patch_size=16, width=32, layers=2, num_heads=4, output_dim=16,
                    image_size=64),
}
