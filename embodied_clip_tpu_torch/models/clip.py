"""CLIP model assembly: visual tower, text tower, contrastive head (port of
`embodied_clip_tpu/models/clip.py`).

Covers the reference's model set: RN50 (headline), RN50x16, ViT-B/32, and the
smoke-scale RNtiny / ViTtiny. CLIP is used frozen, in inference.

State_dict layout is openai/CLIP's: `CLIPVisual` (ResNets) and `CLIPViTVisual` are the
visual towers with `visual.*`'s keys (prefix stripped); `CLIP` is the text tower with
`visual` and `logit_scale` beside it, so its keys are the full release's
(`token_embedding.weight`, `positional_embedding`, `transformer.*`, `ln_final.*`,
`text_projection`, `logit_scale`, `visual.*`).

Random weights (`init_weights_`) follow flax's default initializers, as the JAX package
draws them, from a CPU generator: the same seed gives the same weights on every device
and in every dtype, and `build_clip(name, seed=s).visual` holds `build_encoder`'s weights
of seed s.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from embodied_clip_tpu_torch.models.clip_resnet import (
    CLIP_RESNET_CONFIGS,
    AttentionPool2d,
    ModifiedResNet,
)
from embodied_clip_tpu_torch.models.clip_text import CLIP_TEXT_CONFIGS, TextTransformer
from embodied_clip_tpu_torch.models.clip_vit import CLIP_VIT_CONFIGS, VisionTransformer
from embodied_clip_tpu_torch.models.transformer import MultiHeadAttention

__all__ = ["CLIP", "CLIPVisual", "CLIPViTVisual", "clip_visual", "build_clip",
           "build_visual", "image_size_of", "init_weights_", "CLIP_MODELS"]

CLIP_MODELS = ("RN50", "RN50x16", "ViT-B/32", "ViT-L/14@336px")


def image_size_of(name: str) -> int:
    if name in CLIP_RESNET_CONFIGS:
        return CLIP_RESNET_CONFIGS[name]["image_size"]
    return CLIP_VIT_CONFIGS[name]["image_size"]


class CLIPVisual(ModifiedResNet):
    """ResNet visual tower exposing the reference's three feature views in one pass:
    conv map, avgpool, attnpool/embed (thor_image_features.py:103-113).

    A subclass of the trunk with `attnpool` beside it, so its state_dict keys are
    exactly those of openai/CLIP's `visual.*` (prefix stripped)."""

    def __init__(self, model_name: str, dtype=torch.float32, folded: bool = False):
        if model_name not in CLIP_RESNET_CONFIGS:
            raise ValueError(f"unknown CLIP ResNet visual: {model_name}")
        cfg = CLIP_RESNET_CONFIGS[model_name]
        super().__init__(cfg["stage_sizes"], cfg["width"], dtype, folded)
        self.attnpool = AttentionPool2d(cfg["image_size"] // 32, self.embed_dim,
                                        cfg["num_heads"], cfg["output_dim"], dtype)

    def forward(self, x):
        """NHWC image batch → {conv (NHWC), avgpool, embed}."""
        conv = super().forward(x)
        avg = conv.to(torch.float32).mean(dim=(1, 2)).to(conv.dtype)
        return {"conv": conv, "avgpool": avg, "embed": self.attnpool(conv)}


class CLIPViTVisual(VisionTransformer):
    """ViT visual tower: `{embed}` only (`clip.py:56-57`). It has no BN to fold."""

    def __init__(self, model_name: str, dtype=torch.float32):
        if model_name not in CLIP_VIT_CONFIGS:
            raise ValueError(f"unknown CLIP ViT visual: {model_name}")
        super().__init__(dtype=dtype, **CLIP_VIT_CONFIGS[model_name])

    def forward(self, x):
        return {"embed": super().forward(x)}


def clip_visual(model_name: str, dtype=torch.float32, folded: bool = False) -> nn.Module:
    """The visual tower of `model_name`: `CLIPVisual` for the ResNets, `CLIPViTVisual`
    for the ViTs (which have no BN to fold)."""
    if model_name in CLIP_VIT_CONFIGS:
        return CLIPViTVisual(model_name, dtype)
    return CLIPVisual(model_name, dtype, folded=folded)


class CLIP(TextTransformer):
    """Full dual-tower CLIP with contrastive logits (`clip.py:66-92`)."""

    def __init__(self, model_name: str, dtype=torch.float32):
        super().__init__(dtype=dtype, **CLIP_TEXT_CONFIGS[model_name])
        self.visual = clip_visual(model_name, dtype)
        self.logit_scale = nn.Parameter(torch.empty(()))  # f32

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """Preprocessed NHWC images → (N, D) embeddings in the compute dtype."""
        return self.visual(images)["embed"]

    def forward(self, images: torch.Tensor, tokens: torch.Tensor):
        """(logits_per_image (N_img, N_txt), logits_per_text): exp(logit_scale) × the
        cosine similarities of the f32 L2-normalised embeddings."""
        img = F.normalize(self.encode_image(images).float(), dim=-1, eps=0.0)
        txt = F.normalize(self.encode_text(tokens).float(), dim=-1, eps=0.0)
        logits_per_image = self.logit_scale.exp() * img @ txt.t()
        return logits_per_image, logits_per_image.t()


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's default kernel init: a normal of variance 1/fan_in, truncated at ±2σ."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


@torch.no_grad()
def init_weights_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Fill `module` (on the CPU) with flax's defaults, as the JAX package's modules
    draw them: truncated LeCun-normal conv and dense kernels (the fused in-proj as one
    (C, 3C) kernel), zero biases, identity BN and LayerNorm, N(0, 1/features) token
    embeddings; then the free parameters: the attention pool's N(0, 1/C) positional
    embedding, the ViT's class/positional embeddings and projection at width^-½·N(0, 1),
    the text tower's 0.01·N(0, 1) positional embedding and width^-½·N(0, 1) projection,
    and CLIP's logit scale log(1/0.07). A `CLIP`'s visual tower is drawn first, so it
    holds the weights its encoder draws from the same generator."""
    if isinstance(module, CLIP):
        init_weights_(module.visual, gen)
        mods = [m for name, m in module.named_modules()
                if name != "visual" and not name.startswith("visual.")]
    else:
        mods = list(module.modules())
    for m in mods:
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            _lecun_normal_(m.weight, m.weight[0].numel(), gen)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, MultiHeadAttention):
            _lecun_normal_(m.in_proj_weight, m.in_proj_weight.shape[1], gen)
            nn.init.zeros_(m.in_proj_bias)
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, 0.0, m.weight.shape[1] ** -0.5, generator=gen)
    for m in mods:
        if isinstance(m, AttentionPool2d):
            pos = m.positional_embedding
            nn.init.normal_(pos, 0.0, pos.shape[1] ** -0.5, generator=gen)
        elif isinstance(m, VisionTransformer):
            scale = m.class_embedding.shape[0] ** -0.5
            for p in (m.class_embedding, m.positional_embedding, m.proj):
                nn.init.normal_(p, 0.0, scale, generator=gen)
        if isinstance(m, TextTransformer):
            nn.init.normal_(m.positional_embedding, 0.0, 0.01, generator=gen)
            nn.init.normal_(m.text_projection, 0.0, m.text_projection.shape[0] ** -0.5,
                            generator=gen)
        if isinstance(m, CLIP):
            m.logit_scale.fill_(math.log(1 / 0.07))
    return module


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "on the CPU")
    return device


def _build(make, dtype, seed: int, device) -> nn.Module:
    """`make(dtype)` holding the f32 weights `init_weights_` draws from `seed`, on
    `device` in `dtype` (the f32 islands stay f32): frozen, eval."""
    device = _device(device)
    with torch.device("meta"):
        ref, module = make(torch.float32), make(dtype)
    sd = init_weights_(ref.to_empty(device="cpu"), torch.Generator().manual_seed(seed))
    module = module.to_empty(device=device)
    module.load_state_dict(sd.state_dict())
    return module.eval().requires_grad_(False)


def build_visual(name: str, dtype=torch.float32, seed: int = 0, device="cuda") -> nn.Module:
    """The visual tower `name` with random weights from `seed` (unfolded)."""
    return _build(lambda dt: clip_visual(name, dt), dtype, seed, device)


def build_clip(name: str, dtype=torch.float32, seed: int = 0, device="cuda") -> CLIP:
    """Dual-tower CLIP `name` ∈ CLIP_TEXT_CONFIGS with random weights from `seed`, on the
    GPU unless `device` says otherwise. Load a release with `load_state_dict` (after
    dropping the archive's `input_resolution`, `context_length`, `vocab_size`)."""
    return _build(lambda dt: CLIP(name, dt), dtype, seed, device)

