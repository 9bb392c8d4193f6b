"""The reference repository's preprocessing in plain PyTorch, float32:
Resize(n, BICUBIC) of the short side -> CenterCrop(n) -> ToTensor -> Normalize.

PIL's antialiased bicubic resize is separable: each output row (column) is a
normalised weighted sum of input rows (columns), the kernel's support widened by the
downscale factor, and PIL stores each pass back to uint8 (rounded, clipped). The
weights below are a frozen copy of `embodied_clip_tpu_torch/ops/resize.py`'s
`resample_weights` and `resize_plan` (PIL's `precompute_coeffs`, Keys cubic a = -0.5),
kept here so that the yardstick does not move with the program.
"""

from __future__ import annotations

import numpy as np
import torch

MEANS = {"clip": (0.48145466, 0.4578275, 0.40821073), "imagenet": (0.485, 0.456, 0.406)}
STDS = {"clip": (0.26862954, 0.26130258, 0.27577711), "imagenet": (0.229, 0.224, 0.225)}


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax < 1.0, (a + 2.0) * ax ** 3 - (a + 3.0) * ax ** 2 + 1.0,
                    np.where(ax < 2.0, a * (ax ** 3 - 5.0 * ax ** 2 + 8.0 * ax - 4.0), 0.0))


def resample_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) float32 row-stochastic bicubic resampling matrix, PIL's semantics."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    radius = 2.0 * filterscale
    w = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - radius + 0.5), 0)
        hi = min(int(center + radius + 0.5), in_size)
        xs = np.arange(lo, hi, dtype=np.float64)
        ws = _cubic((xs + 0.5 - center) / filterscale)
        if ws.sum() != 0.0:
            ws = ws / ws.sum()
        w[i, lo:hi] = ws
    return w.astype(np.float32)


def plan(h: int, w: int, size: int):
    """(Wh, Ww): resize of the short side to `size`, center crop to size x size."""
    if h <= w:
        rh, rw = size, max(1, round(w * size / h))
    else:
        rh, rw = max(1, round(h * size / w)), size
    wh, ww = resample_weights(h, rh), resample_weights(w, rw)
    top, left = (rh - size) // 2, (rw - size) // 2
    return wh[top:top + size], ww[left:left + size]


def _u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x * 255.0), 0.0, 255.0) / 255.0


def preprocess(frames: torch.Tensor, size: int, family: str) -> torch.Tensor:
    """uint8 NHWC frames (or the flat (n, h, w*3) view) -> normalised NCHW float32."""
    if frames.ndim == 3:
        frames = frames.reshape(frames.shape[0], frames.shape[1], -1, 3)
    n, h, w, _ = frames.shape
    wh, ww = plan(h, w, size)
    dev = frames.device
    x = frames.to(torch.float32) / 255.0
    x = _u8(torch.einsum("ow,nhwc->nhoc", torch.from_numpy(ww).to(dev), x))
    x = _u8(torch.einsum("oh,nhwc->nowc", torch.from_numpy(wh).to(dev), x))
    mean = torch.tensor(MEANS[family], device=dev)
    std = torch.tensor(STDS[family], device=dev)
    return ((x - mean) / std).permute(0, 3, 1, 2).contiguous()
