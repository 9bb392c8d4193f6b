"""The frozen encoder inside the rollout (M7): uint8 frames → the policy's visual
features, as `examples/train_objectnav.py --frames [--int8]` and the RL experiments'
`_encode_fn` build them in the JAX package (`config/rl_experiments.py:255-296`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from embodied_clip_tpu_torch.models.encoders import FrozenEncoder, build_encoder
from embodied_clip_tpu_torch.parity import golden_frames

__all__ = ["FrameEncoder", "frozen_encode_fn"]


@dataclasses.dataclass
class FrameEncoder:
    """The rollout's `encode_fn`: uint8 (B, H, W, 3) frames → `encoder`'s `key` feature,
    of per-frame shape `feature_shape`. The result is an inference tensor on the
    encoder's device (the rollout copies it into its storage)."""

    encoder: FrozenEncoder
    key: str
    feature_shape: Tuple[int, ...]

    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        return self.encoder.encode(frames)[self.key]


def frozen_encode_fn(name: str = "clip_rn50", dtype=torch.bfloat16, int8: bool = False,
                     calibration_frames: Optional[np.ndarray] = None, device="cuda",
                     torch_checkpoint: Optional[str] = None
                     ) -> Tuple[FrameEncoder, bool]:
    """The encoder `name` (random weights from seed 0, or a reference checkpoint), BN
    folded; with `int8`, quantized on `calibration_frames` (representative uint8
    frames; default `golden_frames(16)`). Picks the conv-map key (`*_conv`) for the
    policy's compressor. Returns (encode_fn, visual_is_map)."""
    enc = build_encoder(name, dtype=dtype, torch_checkpoint=torch_checkpoint,
                        device=device).fold_bn()
    if int8:
        enc = enc.quantize(golden_frames(16) if calibration_frames is None
                           else calibration_frames)
    probe = enc.encode(np.zeros((1, enc.image_size, enc.image_size, 3), np.uint8))
    key = next((k for k in sorted(probe) if k.endswith("_conv")), sorted(probe)[0])
    return FrameEncoder(enc, key, tuple(probe[key].shape[1:])), probe[key].ndim == 4
