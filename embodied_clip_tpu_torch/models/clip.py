"""CLIP visual tower for the ResNet configs (port of
`embodied_clip_tpu/models/clip.py:CLIPVisual`)."""

from __future__ import annotations

import torch

from embodied_clip_tpu_torch.models.clip_resnet import (
    CLIP_RESNET_CONFIGS,
    AttentionPool2d,
    ModifiedResNet,
)

__all__ = ["CLIPVisual", "image_size_of"]


def image_size_of(name: str) -> int:
    return CLIP_RESNET_CONFIGS[name]["image_size"]


class CLIPVisual(ModifiedResNet):
    """Visual tower exposing the reference's three feature views in one pass: conv
    map, avgpool, attnpool/embed (thor_image_features.py:103-113).

    A subclass of the trunk with `attnpool` beside it, so its state_dict keys are
    exactly those of openai/CLIP's `visual.*` (prefix stripped)."""

    def __init__(self, model_name: str, dtype=torch.float32, folded: bool = False,
                 fused_bottlenecks: bool = True):
        if model_name not in CLIP_RESNET_CONFIGS:
            raise ValueError(f"unknown CLIP ResNet visual: {model_name}")
        cfg = CLIP_RESNET_CONFIGS[model_name]
        super().__init__(cfg["stage_sizes"], cfg["width"], dtype, folded, fused_bottlenecks)
        self.attnpool = AttentionPool2d(cfg["image_size"] // 32, self.embed_dim,
                                        cfg["num_heads"], cfg["output_dim"], dtype)

    def forward(self, x):
        """NHWC image batch → {conv (NHWC), avgpool, embed}."""
        conv = super().forward(x)
        avg = conv.to(torch.float32).mean(dim=(1, 2)).to(conv.dtype)
        return {"conv": conv, "avgpool": avg, "embed": self.attnpool(conv)}
