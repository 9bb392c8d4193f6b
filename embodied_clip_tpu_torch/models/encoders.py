"""Frozen visual encoders: uint8 frames → features (port of
`embodied_clip_tpu/models/encoders.py` for the CLIP ResNets and ViTs and the
torchvision ResNets).

The raw uint8 frame batch goes to the device once; preprocess (kernel K1 in bf16, the
plain f32 path otherwise), the trunk and all pooling heads run there, under
`torch.inference_mode()`. Keys match the reference's cache schema
(thor_image_features.py:129-138): {clip_conv, clip_avgpool, clip_attnpool},
{clip_embed} for the ViTs and {imagenet_conv, imagenet_avgpool}, with the conv map NHWC
as in the JAX package.
`fold_bn()` gives the serving configuration, whose bf16 bottleneck trunks run kernels
K6/K7 (models/stages.py); a ViT has no BN, and `fold_bn()` returns it as it is.
`FrozenEncoder.quantize()` returns the int8 encoder (`_QuantizedCLIPEncoder`,
`_QuantizedViTEncoder`, `_QuantizedResNetEncoder`; port of
`embodied_clip_tpu/models/encoders.py:221-264,280-457`).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from embodied_clip_tpu_torch.models.clip import (
    CLIPViTVisual,
    CLIPVisual,
    _device,
    clip_visual,
    image_size_of,
    init_weights_,
)
from embodied_clip_tpu_torch.models.clip_resnet import ModifiedResNet
from embodied_clip_tpu_torch.models.clip_vit import CLIP_VIT_CONFIGS
from embodied_clip_tpu_torch.models.convert import load_torch_checkpoint, visual_state_dict
from embodied_clip_tpu_torch.models.resnet import RESNET_CONFIGS, ResNet
from embodied_clip_tpu_torch.ops.fold_bn import fold_conv_bn_state_dict
from embodied_clip_tpu_torch.ops.preprocess import make_preprocessor
from embodied_clip_tpu_torch.utils.profiling import span

__all__ = ["EncoderSpec", "FrozenEncoder", "build_encoder", "ENCODER_SPECS"]


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    family: str  # 'imagenet' | 'clip': the preprocess constant set and key prefix
    arch: str    # a key of RESNET_CONFIGS, CLIP_RESNET_CONFIGS or CLIP_VIT_CONFIGS


ENCODER_SPECS = {
    "imagenet_rn50": EncoderSpec("imagenet", "resnet50"),
    "imagenet_rn18": EncoderSpec("imagenet", "resnet18"),
    "clip_rn50": EncoderSpec("clip", "RN50"),
    "clip_rn50x16": EncoderSpec("clip", "RN50x16"),
    "clip_vit_b32": EncoderSpec("clip", "ViT-B/32"),
    "clip_vit_l14_336": EncoderSpec("clip", "ViT-L/14@336px"),
    # Smoke-scale CLIP ResNet/ViT (full code path, CPU-test cost; not paper models).
    "clip_rn_tiny": EncoderSpec("clip", "RNtiny"),
    "clip_vit_tiny": EncoderSpec("clip", "ViTtiny"),
}


def _new_module(spec: EncoderSpec, dtype=torch.float32, folded: bool = False) -> nn.Module:
    if spec.family == "imagenet":
        return ResNet(dtype=dtype, folded=folded, **RESNET_CONFIGS[spec.arch])
    return clip_visual(spec.arch, dtype, folded=folded)


def _random_state_dict(spec: EncoderSpec, seed: int) -> Dict[str, torch.Tensor]:
    """Random f32 weights from a seeded generator, made on the CPU, so every device
    and dtype built from one seed holds the same weights: flax's defaults
    (`models/clip.init_weights_`)."""
    with torch.device("meta"):
        module = _new_module(spec)
    module = module.to_empty(device="cpu")
    return init_weights_(module, torch.Generator().manual_seed(seed)).state_dict()


def _make_module(spec: EncoderSpec, dtype, folded: bool, sd, device) -> nn.Module:
    """The spec's module on `device` in `dtype` holding `sd`: frozen, eval,
    channels-last."""
    with torch.device("meta"):
        module = _new_module(spec, dtype, folded)
    module = module.to_empty(device=device)
    module.load_state_dict(sd)
    return module.to(memory_format=torch.channels_last).eval().requires_grad_(False)


def _frames(frames) -> torch.Tensor:
    if isinstance(frames, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(frames))
    return frames


def _avgpool(conv: torch.Tensor) -> torch.Tensor:
    """Global mean of an NHWC map in f32, cast back (encoders.py:120-125)."""
    return conv.to(torch.float32).mean(dim=(1, 2)).to(conv.dtype)


class FrozenEncoder:
    """A frozen encoder: module + fused preprocess, with `encode(frames_u8)`."""

    def __init__(self, spec: EncoderSpec, module: nn.Module, image_size: int,
                 dtype=torch.float32, device="cuda"):
        self.spec = spec
        self.module = module
        self.image_size = image_size
        self.dtype = dtype
        self.device = torch.device(device)
        self.preprocess = make_preprocessor(spec.family, image_size, dtype)

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        """Preprocessed frames → the NHWC conv map, or a ViT's embedding."""
        if isinstance(self.module, CLIPViTVisual):
            return self.module(x)["embed"]
        # CLIPVisual's trunk alone: its forward adds the heads.
        if isinstance(self.module, CLIPVisual):
            return ModifiedResNet.forward(self.module, x)
        return self.module(x)

    @torch.inference_mode()
    def encode(self, frames) -> Dict[str, torch.Tensor]:
        """uint8 NHWC frames (any HxW), or the flat (n, h, w*3) view, as a tensor or
        a numpy array → feature dict on the encoder's device. One `encode` span, with
        `encode.to_device`, `.preprocess`, `.trunk` and `.heads` inside (a ViT's tower
        is all trunk)."""
        with span("encode"):
            with span("encode.to_device"):
                frames = _frames(frames).to(self.device)
            with span("encode.preprocess"):
                x = self.preprocess(frames)
            with span("encode.trunk"):
                out = self._trunk(x)
                if isinstance(self.module, CLIPViTVisual):
                    return {"clip_embed": out}
            with span("encode.heads"):
                if self.spec.family == "imagenet":
                    return {"imagenet_conv": out, "imagenet_avgpool": _avgpool(out)}
                return {"clip_conv": out, "clip_avgpool": _avgpool(out),
                        "clip_attnpool": self.module.attnpool(out)}

    def fold_bn(self) -> "FrozenEncoder":
        """A new encoder with frozen BN folded into the conv weights (ops/fold_bn.py):
        the serving configuration, conv+bias+relu in the compute dtype. In bf16 its
        bottleneck trunk runs stage 1 through kernel K7 and the stride-1 identity blocks
        through K6; in f32 every block runs its own forward. An encoder already folded,
        and a ViT, which has no BN, are returned as they are."""
        if isinstance(self.module, CLIPViTVisual) or self.module.folded:
            return self
        sd = fold_conv_bn_state_dict(self.module.state_dict())
        module = _make_module(self.spec, self.dtype, True, sd, self.device)
        return FrozenEncoder(self.spec, module, self.image_size, self.dtype, self.device)

    def quantize(self, calibration_frames) -> "FrozenEncoder":
        """An int8-trunk encoder (ops/quantize.py): s8 bottleneck convs with fused
        requant epilogues; the stem convs, the shortcut convs and the attention pool
        stay in the compute dtype. On CUDA the trunk runs kernels K2, K3 and K5 and the
        stride blocks' launches (`PATH_A`); on the CPU, the same dispatch on their plain
        versions.

        A torchvision-family encoder gets `_QuantizedResNetEncoder`: the same scheme on
        its 7×7 stem (bf16, requantized before an int8 max pool) and its stride-2 convs;
        no kernel runs on that trunk, as in the JAX package. A ViT gets
        `_QuantizedViTEncoder` (ops/quantize_vit.py): its blocks' four denses s8, the
        rest in the compute dtype and f32; no kernel but K1 runs on it.

        `calibration_frames` must be representative uint8 frames (real observations,
        or parity.golden_frames), never noise: the activation scales are maxima over
        them. They go through the encoder's own preprocess (K1 in bf16); calibration
        runs the folded trunk in full f32 (TF32 off), from the encoder's weights
        upcast to f32."""
        from embodied_clip_tpu_torch.models.clip_resnet import CLIP_RESNET_CONFIGS
        from embodied_clip_tpu_torch.ops.quantize import quantize_resnet_trunk, quantize_trunk

        if self.spec.arch in CLIP_VIT_CONFIGS:
            from embodied_clip_tpu_torch.ops.quantize_vit import quantize_vit

            cfg = CLIP_VIT_CONFIGS[self.spec.arch]
            with torch.inference_mode():
                x = self.preprocess(_frames(calibration_frames).to(self.device))
                qtower = quantize_vit(self.module.state_dict(), x, cfg["num_heads"],
                                      cfg["layers"])
            return _QuantizedViTEncoder(self, qtower, cfg["num_heads"], cfg["layers"])
        folded = self.fold_bn()
        sd = {k: v.float() for k, v in folded.module.state_dict().items()
              if not k.startswith("attnpool.")}
        with torch.inference_mode():
            x = folded.preprocess(_frames(calibration_frames).to(self.device))
            if self.spec.family == "imagenet":
                cfg = RESNET_CONFIGS[self.spec.arch]
                qtrunk = quantize_resnet_trunk(sd, cfg["stage_sizes"], cfg["block"], x)
                return _QuantizedResNetEncoder(folded, qtrunk, cfg["stage_sizes"],
                                               cfg["block"])
            stage_sizes = CLIP_RESNET_CONFIGS[self.spec.arch]["stage_sizes"]
            qtrunk = quantize_trunk(sd, stage_sizes, x)
        return _QuantizedCLIPEncoder(folded, qtrunk, stage_sizes)

    def load_torch_state_dict(self, sd) -> "FrozenEncoder":
        """Replace the weights with a reference state_dict: openai/CLIP's (full or
        `visual.*`, ResNet or ViT) for the CLIP family, torchvision's (its `fc.*` head
        dropped, as the reference truncates the model) for the ImageNet family."""
        self.module.load_state_dict(_module_state_dict(self.spec, sd))
        return self


class _QuantizedEncoder(FrozenEncoder):
    """An encoder whose bottleneck trunk is int8 (see FrozenEncoder.quantize); the
    module keeps the folded weights of the parts that stay in the compute dtype.
    `kernels` holds the keywords its `_trunk` passes to the int8 graph;
    `with_kernels(...)` gives an encoder on the same quantized weights with others."""

    def __init__(self, folded: FrozenEncoder, qtrunk, stage_sizes, kernels=None):
        super().__init__(folded.spec, folded.module, folded.image_size, folded.dtype,
                         folded.device)
        self.qtrunk = qtrunk
        self.stage_sizes = tuple(stage_sizes)
        self.kernels = dict(kernels or {})

    def with_kernels(self, **switches) -> "_QuantizedEncoder":
        enc = copy.copy(self)
        enc.kernels = {**self.kernels, **switches}
        return enc

    def quantize(self, calibration_frames) -> "FrozenEncoder":
        return self  # idempotent: already quantized

    def load_torch_state_dict(self, sd) -> "FrozenEncoder":
        raise NotImplementedError("load weights before quantize(): an int8 encoder "
                                  "holds calibrated s8 weights")


class _QuantizedCLIPEncoder(_QuantizedEncoder):
    """CLIP ResNet encoder with an int8 trunk.

    `kernels` holds `quantized_trunk_apply`'s keywords: its five kernel switches
    (`PATH_A` by default) and its options (`recip_requant`, `int8_stem`, `int4_stage1`;
    the JAX package's defaults unless set)."""

    def __init__(self, folded: FrozenEncoder, qtrunk, stage_sizes):
        from embodied_clip_tpu_torch.ops.quantize import PATH_A

        super().__init__(folded, qtrunk, stage_sizes, PATH_A)

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        from embodied_clip_tpu_torch.ops.quantize import quantized_trunk_apply

        return quantized_trunk_apply(self.qtrunk, x, self.stage_sizes, out_dtype=self.dtype,
                                     **self.kernels)


class _QuantizedViTEncoder(_QuantizedEncoder):
    """CLIP ViT encoder with s8 transformer-block denses (ops/quantize_vit.py); its
    `kernels` are `quantized_vit_apply`'s options (`quant_attn`, `recip_requant`)."""

    def __init__(self, folded: FrozenEncoder, qtower, num_heads: int, layers: int):
        super().__init__(folded, qtower, ())
        self.num_heads, self.layers = num_heads, layers

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        from embodied_clip_tpu_torch.ops.quantize_vit import quantized_vit_apply

        return quantized_vit_apply(self.qtrunk, x, self.num_heads, self.layers,
                                   out_dtype=self.dtype, **self.kernels)


class _QuantizedResNetEncoder(_QuantizedEncoder):
    """torchvision-family encoder with an int8 trunk: the plain int8 graph
    (`ops/quantize.quantized_resnet_apply`), which runs no kernel; its one option is
    `recip_requant`."""

    def __init__(self, folded: FrozenEncoder, qtrunk, stage_sizes, block: str):
        super().__init__(folded, qtrunk, stage_sizes)
        self.block = block

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        from embodied_clip_tpu_torch.ops.quantize import quantized_resnet_apply

        return quantized_resnet_apply(self.qtrunk, x, self.stage_sizes, self.block,
                                      out_dtype=self.dtype, **self.kernels)


def _module_state_dict(spec: EncoderSpec, sd) -> Dict[str, torch.Tensor]:
    if spec.family == "imagenet":
        return {k: v for k, v in sd.items() if not k.startswith("fc.")}
    return visual_state_dict(sd)


def build_encoder(name: str, dtype=torch.float32, seed: int = 0,
                  torch_checkpoint: Optional[str] = None,
                  device="cuda") -> FrozenEncoder:
    """name ∈ ENCODER_SPECS. Random-init from `seed` unless a torch checkpoint path is
    given (openai/CLIP's for `clip_*`, torchvision's for `imagenet_*`). Runs on the GPU
    unless `device` says otherwise."""
    if name not in ENCODER_SPECS:
        raise NotImplementedError(
            f"encoder {name!r} is not ported to PyTorch (ported: "
            f"{', '.join(ENCODER_SPECS)}); see ROADMAP.md, queue 1")
    device = _device(device)
    spec = ENCODER_SPECS[name]
    if torch_checkpoint is not None:
        sd = _module_state_dict(spec, load_torch_checkpoint(torch_checkpoint))
    else:
        sd = _random_state_dict(spec, seed)
    module = _make_module(spec, dtype, False, sd, device)
    size = 224 if spec.family == "imagenet" else image_size_of(spec.arch)
    return FrozenEncoder(spec, module, size, dtype, device)
