"""Frozen visual encoders: uint8 frames → features (port of
`embodied_clip_tpu/models/encoders.py` for the CLIP ResNets).

The raw uint8 frame batch goes to the device once; preprocess (kernel K1 in bf16, the
plain f32 path otherwise), the trunk and all pooling heads run there, under
`torch.inference_mode()`. Keys match the reference's cache schema
(thor_image_features.py:129-138): {clip_conv, clip_avgpool, clip_attnpool}, with the
conv map NHWC as in the JAX package. `FrozenEncoder.quantize()` returns the int8-trunk
encoder (`_QuantizedCLIPEncoder`, port of `embodied_clip_tpu/models/encoders.py:
221-264,280-403`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from embodied_clip_tpu_torch.models.clip import CLIPVisual, image_size_of
from embodied_clip_tpu_torch.models.convert import load_torch_checkpoint, visual_state_dict
from embodied_clip_tpu_torch.ops.fold_bn import fold_conv_bn_state_dict
from embodied_clip_tpu_torch.ops.preprocess import make_preprocessor

__all__ = ["EncoderSpec", "FrozenEncoder", "build_encoder", "ENCODER_SPECS"]


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    family: str  # 'clip': the preprocess constant set
    arch: str    # 'RN50' | 'RN50x16' | 'RNtiny'


ENCODER_SPECS = {
    "clip_rn50": EncoderSpec("clip", "RN50"),
    "clip_rn50x16": EncoderSpec("clip", "RN50x16"),
    # Smoke-scale CLIP ResNet (full code path, CPU-test cost; not a paper model).
    "clip_rn_tiny": EncoderSpec("clip", "RNtiny"),
}


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "on the CPU")
    return device


def _random_state_dict(arch: str, seed: int) -> Dict[str, torch.Tensor]:
    """Random f32 weights from a seeded generator, made on the CPU, so every device
    and dtype built from one seed holds the same weights. Flax's defaults: truncated
    LeCun-normal kernels, zero biases, identity BN, N(0, 1/c) positional embedding."""
    with torch.device("meta"):
        module = CLIPVisual(arch)
    module = module.to_empty(device="cpu")
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            std = (1.0 / m.weight[0].numel()) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=gen)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    pos = module.attnpool.positional_embedding
    nn.init.normal_(pos, 0.0, pos.shape[1] ** -0.5, generator=gen)
    return module.state_dict()


def _make_module(arch: str, dtype, folded: bool, sd, device) -> CLIPVisual:
    """CLIPVisual on `device` in `dtype` holding `sd`: frozen, eval, channels-last."""
    with torch.device("meta"):
        module = CLIPVisual(arch, dtype, folded=folded)
    module = module.to_empty(device=device)
    module.load_state_dict(sd)
    return module.to(memory_format=torch.channels_last).eval().requires_grad_(False)


class FrozenEncoder:
    """A frozen encoder: module + fused preprocess, with `encode(frames_u8)`."""

    def __init__(self, spec: EncoderSpec, module: CLIPVisual, image_size: int,
                 dtype=torch.float32, device="cuda"):
        self.spec = spec
        self.module = module
        self.image_size = image_size
        self.dtype = dtype
        self.device = torch.device(device)
        self.preprocess = make_preprocessor(spec.family, image_size, dtype)
        if dtype == torch.bfloat16:
            # Throughput mode: kernel K1 on CUDA frames. f32 encoders keep the
            # full-precision plain path.
            self.preprocess = dataclasses.replace(self.preprocess, use_kernel=True)

    @torch.inference_mode()
    def encode(self, frames) -> Dict[str, torch.Tensor]:
        """uint8 NHWC frames (any HxW), or the flat (n, h, w*3) view, as a tensor or
        a numpy array → feature dict on the encoder's device."""
        if isinstance(frames, np.ndarray):
            frames = torch.from_numpy(np.ascontiguousarray(frames))
        feats = self.module(self.preprocess(frames.to(self.device)))
        return {"clip_conv": feats["conv"], "clip_avgpool": feats["avgpool"],
                "clip_attnpool": feats["embed"]}

    def fold_bn(self) -> "FrozenEncoder":
        """A new encoder with frozen BN folded into the conv weights (ops/fold_bn.py):
        the serving configuration, pure conv+bias+relu in the compute dtype."""
        if self.module.folded:
            return self
        sd = fold_conv_bn_state_dict(self.module.state_dict())
        module = _make_module(self.spec.arch, self.dtype, True, sd, self.device)
        return FrozenEncoder(self.spec, module, self.image_size, self.dtype, self.device)

    def quantize(self, calibration_frames) -> "FrozenEncoder":
        """An int8-trunk encoder (ops/quantize.py): s8 bottleneck convs with fused
        requant epilogues; the stem convs, the shortcut convs and the attention pool
        stay in the compute dtype. On CUDA the trunk runs kernels K2, K3 and K5
        (`PATH_A`); on the CPU, the same dispatch on their plain versions.

        `calibration_frames` must be representative uint8 frames (real observations,
        or parity.golden_frames), never noise: the activation scales are maxima over
        them. They go through the encoder's own preprocess (K1 in bf16); calibration
        runs the folded trunk in full f32 (TF32 off), from the encoder's weights
        upcast to f32."""
        from embodied_clip_tpu_torch.models.clip_resnet import CLIP_RESNET_CONFIGS
        from embodied_clip_tpu_torch.ops.quantize import quantize_trunk

        if self.spec.family != "clip" or self.spec.arch not in CLIP_RESNET_CONFIGS:
            raise NotImplementedError(
                f"no int8 path for {self.spec.arch} in the port (the torchvision and ViT "
                "int8 trunks are not ported); see ROADMAP.md, queue 1, M8")
        folded = self.fold_bn()
        if isinstance(calibration_frames, np.ndarray):
            calibration_frames = torch.from_numpy(np.ascontiguousarray(calibration_frames))
        stage_sizes = CLIP_RESNET_CONFIGS[self.spec.arch]["stage_sizes"]
        sd = {k: v.float() for k, v in folded.module.state_dict().items()
              if not k.startswith("attnpool.")}
        with torch.inference_mode():
            x = folded.preprocess(calibration_frames.to(self.device))
            qtrunk = quantize_trunk(sd, stage_sizes, x)
        return _QuantizedCLIPEncoder(folded, qtrunk, stage_sizes)

    def load_torch_state_dict(self, sd) -> "FrozenEncoder":
        """Replace the weights with an openai/CLIP state_dict (full or `visual.*`)."""
        self.module.load_state_dict(visual_state_dict(sd))
        return self


class _QuantizedCLIPEncoder(FrozenEncoder):
    """CLIP ResNet encoder with an int8 trunk (see FrozenEncoder.quantize).

    `kernels` holds `quantized_trunk_apply`'s four switches: `PATH_A` by default;
    `with_kernels(...)` gives an encoder on the same quantized weights with others."""

    def __init__(self, folded: FrozenEncoder, qtrunk, stage_sizes, kernels=None):
        from embodied_clip_tpu_torch.ops.quantize import PATH_A

        super().__init__(folded.spec, folded.module, folded.image_size, folded.dtype,
                         folded.device)
        self.qtrunk = qtrunk
        self.stage_sizes = tuple(stage_sizes)
        self.kernels = dict(PATH_A if kernels is None else kernels)

    def with_kernels(self, **switches) -> "_QuantizedCLIPEncoder":
        folded = FrozenEncoder(self.spec, self.module, self.image_size, self.dtype,
                               self.device)
        return _QuantizedCLIPEncoder(folded, self.qtrunk, self.stage_sizes,
                                     {**self.kernels, **switches})

    @torch.inference_mode()
    def encode(self, frames) -> Dict[str, torch.Tensor]:
        from embodied_clip_tpu_torch.ops.quantize import quantized_trunk_apply

        if isinstance(frames, np.ndarray):
            frames = torch.from_numpy(np.ascontiguousarray(frames))
        x = self.preprocess(frames.to(self.device))
        conv = quantized_trunk_apply(self.qtrunk, x, self.stage_sizes,
                                     out_dtype=self.dtype, **self.kernels)
        avg = conv.to(torch.float32).mean(dim=(1, 2)).to(conv.dtype)
        return {"clip_conv": conv, "clip_avgpool": avg,
                "clip_attnpool": self.module.attnpool(conv)}

    def fold_bn(self) -> "FrozenEncoder":
        return self  # already folded and quantized

    def quantize(self, calibration_frames) -> "FrozenEncoder":
        return self  # idempotent: already quantized

    def load_torch_state_dict(self, sd) -> "FrozenEncoder":
        raise NotImplementedError("load weights before quantize(): an int8 encoder "
                                  "holds calibrated s8 weights")


def build_encoder(name: str, dtype=torch.float32, seed: int = 0,
                  torch_checkpoint: Optional[str] = None,
                  device="cuda") -> FrozenEncoder:
    """name ∈ ENCODER_SPECS. Random-init from `seed` unless a torch checkpoint path is
    given. Runs on the GPU unless `device` says otherwise."""
    if name not in ENCODER_SPECS:
        raise NotImplementedError(
            f"encoder {name!r} is not ported to PyTorch (ported: "
            f"{', '.join(ENCODER_SPECS)}); see ROADMAP.md, queue 1")
    device = _device(device)
    spec = ENCODER_SPECS[name]
    if torch_checkpoint is not None:
        sd = visual_state_dict(load_torch_checkpoint(torch_checkpoint))
    else:
        sd = _random_state_dict(spec.arch, seed)
    module = _make_module(spec.arch, dtype, False, sd, device)
    return FrozenEncoder(spec, module, image_size_of(spec.arch), dtype, device)
