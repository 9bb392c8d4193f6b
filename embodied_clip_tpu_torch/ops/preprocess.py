"""uint8 frames → normalised tensor (port of `embodied_clip_tpu/ops/preprocess.py`).

  - ImageNet path: Resize(224, BICUBIC) → CenterCrop(224) → ToTensor →
    Normalize(mean=[0.485,0.456,0.406], std=[0.229,0.224,0.225])
  - CLIP path: Resize(n, BICUBIC) → CenterCrop(n) → RGB → [0,1] →
    Normalize(CLIP mean/std); n = 224 for RN50, 384 for RN50x16.

The raw uint8 batch is shipped to the device once; resize (crop folded into the
matrices), normalise and the dtype cast run there. On a CUDA tensor with `use_kernel`
the whole pipeline is one launch of kernel K1 (`ops/kernels/preprocess_kernel.py`);
otherwise it is the plain f32 path below.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from embodied_clip_tpu_torch import constants
from embodied_clip_tpu_torch.ops.resize import apply_resize, resize_plan


@dataclasses.dataclass(frozen=True)
class Preprocessor:
    """A static preprocessing plan; `__call__` maps frames to normalised NHWC."""

    size: int
    mean: Tuple[float, float, float]
    std: Tuple[float, float, float]
    method: str = "bicubic"
    dtype: torch.dtype = torch.float32
    # Run the whole pipeline as kernel K1 on CUDA tensors. Requires uint8 input with
    # an actual resize; other inputs, and CPU tensors, take the plain f32 path.
    use_kernel: bool = False

    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        """uint8/float NHWC (or HWC) frames → normalized NHWC in self.dtype.

        Also accepts the flat-channels layout (n, h, w*3), a free view of a contiguous
        NHWC buffer."""
        flat = frames.ndim == 3 and frames.shape[-1] != 3
        if flat:
            n, h, w3 = frames.shape
            if w3 % 3:
                raise ValueError(f"flat frames last dim must be w*3, got {w3}")
            frames = frames.reshape(n, h, w3 // 3, 3)
        squeeze = frames.ndim == 3
        if squeeze:
            frames = frames[None]
        n, h, w, c = frames.shape
        is_u8 = frames.dtype == torch.uint8
        if (self.use_kernel and is_u8 and (h, w) != (self.size, self.size)
                and frames.is_cuda):
            from embodied_clip_tpu_torch.ops.kernels.preprocess_kernel import (
                fused_preprocess,
            )

            out = fused_preprocess(frames.contiguous(), self.size, self.mean, self.std,
                                   self.method, self.dtype)
            return out[0] if squeeze else out
        # Filter in f32 regardless of output dtype: the weights are row-stochastic so
        # f32 accumulation keeps the features within the 1e-3 fidelity envelope even
        # when the encoder itself runs bf16. uint8 frames get PIL's per-pass uint8
        # round/clip (bit-faithful parity); float frames are filtered exactly.
        x = frames.to(torch.float32)
        if is_u8:
            x = x / 255.0
        if (h, w) != (self.size, self.size):
            wh, ww = resize_plan((h, w), self.size, (self.size, self.size), self.method)
            x = apply_resize(x, wh, ww, pil_exact=is_u8)
        mean = torch.tensor(self.mean, dtype=torch.float32, device=x.device)
        std = torch.tensor(self.std, dtype=torch.float32, device=x.device)
        x = ((x - mean) / std).to(self.dtype)
        return x[0] if squeeze else x


def make_preprocessor(kind: str, size: int = 224, dtype=torch.float32) -> Preprocessor:
    """kind ∈ {'imagenet', 'clip'} — the two reference constant sets."""
    if kind == "imagenet":
        return Preprocessor(size, constants.IMAGENET_MEAN, constants.IMAGENET_STD,
                            dtype=dtype)
    if kind == "clip":
        return Preprocessor(size, constants.CLIP_MEAN, constants.CLIP_STD, dtype=dtype)
    raise ValueError(f"unknown preprocessor kind: {kind!r}")
