"""PIL-parity separable image resampling (port of `embodied_clip_tpu/ops/resize.py`).

PIL's antialiased BICUBIC resize is separable: each output row/column is a normalised
weighted sum of input rows/columns, with the kernel support widened by the downscale
factor. The (out, in) weight matrices are computed once on the host in float64
(`resample_weights`, `resize_plan`: copied from the JAX package as numpy); the resize
itself is two f32 matmuls with PIL's per-pass uint8 round + clip between them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _bicubic_kernel(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    # Keys cubic kernel, a=-0.5 — identical to PIL's `bicubic_filter`.
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    out = np.where(
        ax < 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * (ax3 - 5.0 * ax2 + 8.0 * ax - 4.0), 0.0),
    )
    return out


def _bilinear_kernel(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    return np.maximum(0.0, 1.0 - ax)


_KERNELS = {
    "bicubic": (_bicubic_kernel, 2.0),
    "bilinear": (_bilinear_kernel, 1.0),
}


@functools.lru_cache(maxsize=64)
def resample_weights(in_size: int, out_size: int, method: str = "bicubic") -> np.ndarray:
    """(out_size, in_size) float32 row-stochastic resampling matrix, PIL semantics.

    Mirrors PIL's `precompute_coeffs`: kernel support scales with the downscale factor
    (antialias), window is clipped to the image, weights are normalized to sum to 1.
    """
    kernel, support = _KERNELS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    radius = support * filterscale

    w = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - radius + 0.5), 0)
        xmax = min(int(center + radius + 0.5), in_size)
        xs = np.arange(xmin, xmax, dtype=np.float64)
        ws = kernel((xs + 0.5 - center) / filterscale)
        s = ws.sum()
        if s != 0.0:
            ws = ws / s
        w[i, xmin:xmax] = ws
    return w.astype(np.float32)


def resize_plan(
    in_hw: tuple[int, int],
    size: int | tuple[int, int],
    crop: tuple[int, int] | None = None,
    method: str = "bicubic",
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side plan: (Wh, Ww) matrices realizing resize(size) [+ center-crop].

    `size` as an int resizes the SHORT side to `size` preserving aspect ratio —
    torchvision `Resize(224)` semantics (reference thor_image_features.py:37). A center
    crop is folded into the matrices by slicing their output rows, so crop is free.
    """
    h, w = in_hw
    if isinstance(size, int):
        if h <= w:
            rh, rw = size, max(1, round(w * size / h))
        else:
            rh, rw = max(1, round(h * size / w)), size
    else:
        rh, rw = size
    wh = resample_weights(h, rh, method)
    ww = resample_weights(w, rw, method)
    if crop is not None:
        ch, cw = crop
        top = (rh - ch) // 2
        left = (rw - cw) // 2
        wh = wh[top : top + ch]
        ww = ww[left : left + cw]
    return wh, ww


def _quantize_u8(x: torch.Tensor) -> torch.Tensor:
    # PIL stores each separable pass back into a uint8 image: round (half to even,
    # as jnp.round) + clip, here in the [0,1] float domain like the JAX path.
    return torch.clamp(torch.round(x * 255.0), 0.0, 255.0) * (1.0 / 255.0)


def apply_resize(x: torch.Tensor, wh: np.ndarray, ww: np.ndarray,
                 pil_exact: bool = True) -> torch.Tensor:
    """Apply a (Wh, Ww) resize plan to NHWC float images in [0,1], in f32.

    PIL order: width pass first, then height, quantizing to the uint8 grid after each
    pass when `pil_exact`."""
    x = x.to(torch.float32)
    ww_t = torch.as_tensor(ww, dtype=torch.float32, device=x.device)
    wh_t = torch.as_tensor(wh, dtype=torch.float32, device=x.device)
    x = torch.einsum("ow,nhwc->nhoc", ww_t, x)
    if pil_exact:
        x = _quantize_u8(x)
    x = torch.einsum("oh,nhwc->nowc", wh_t, x)
    if pil_exact:
        x = _quantize_u8(x)
    return x


def resize_bicubic(img: torch.Tensor, size: int | tuple[int, int],
                   crop: tuple[int, int] | None = None, method: str = "bicubic",
                   dtype=torch.float32, pil_exact: bool = True) -> torch.Tensor:
    """Resize NHWC (or HWC) images with PIL-parity filtering, optionally center-cropped
    (`embodied_clip_tpu/ops/resize.py:156`). uint8 input is scaled to [0, 1]
    (torchvision ToTensor semantics) before filtering; float input is taken as already
    in [0, 1] and filtered without PIL's per-pass uint8 rounding."""
    squeeze = img.ndim == 3
    if squeeze:
        img = img[None]
    # The height crop commutes with the width pass, so the plan folds it in exactly.
    wh, ww = resize_plan(tuple(img.shape[1:3]), size, crop, method)
    x = img.to(torch.float32)
    if img.dtype == torch.uint8:
        x = x / 255.0
    else:
        pil_exact = False
    x = apply_resize(x, wh, ww, pil_exact=pil_exact).to(dtype)
    return x[0] if squeeze else x
