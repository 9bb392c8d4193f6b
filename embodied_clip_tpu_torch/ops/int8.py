"""Plain PyTorch int8 primitives of the quantized CLIP trunk (port of the helpers of
`embodied_clip_tpu/ops/quantize.py`).

These are the arithmetic of the int8 graph written once, in the JAX graph's op order,
for any device: `ops/quantize.py` builds the plain graph from them and the kernels'
plain versions (`ops/kernels/`) reuse them. Every scale is a 0-dim float32 tensor on
the data's device. That matters on CUDA: ATen turns a division by a CPU scalar (a
Python float, or a 0-dim CPU tensor) into a multiply by its reciprocal, which is off
by one s8 step on near-ties; a division by a device tensor is the IEEE divide the
kernels use (`__fdiv_rn`).

s8 products go through `torch._int_mm` (s8×s8→s32, exact; cuBLASLt on CUDA), with
the 3×3 conv (stride 1 or 2, symmetric padding 1) as im2col. No PyTorch CUDA op
computes an s8 convolution.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

__all__ = ["QMAX", "qmm", "qconv_acc", "requant", "requant_signed", "avg_pool_int8",
           "max_pool_int8", "im2col3x3", "full_f32"]

QMAX = 127.0


@contextlib.contextmanager
def full_f32():
    """f32 convolutions and matmuls in full f32: cuDNN convolutions default to TF32."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


def qmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) s8 @ (K, N) s8 → (M, N) s32, exact.

    On CUDA `torch._int_mm` wants M > 16 and K, N multiples of 8: the operands are
    zero-padded to that and the result cut back (zero rows/columns add nothing). The
    second operand goes in column-major, the layout cuBLASLt's int8 GEMM takes at
    every shape (a row-major one is refused at some small shapes)."""
    if a.device.type != "cuda":
        return torch._int_mm(a, b)
    m, k = a.shape
    n = b.shape[1]
    pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    return torch._int_mm(a.contiguous(), b.t().contiguous().t())[:m, :n]


def im2col3x3(x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC (n, h, w, c) → (n, oh, ow, 9c): the 3×3 window with a zero halo of 1 on
    every side (stride 1: 'SAME'; stride 2: the JAX graph's symmetric (1, 1) padding,
    oh = (h - 1) // 2 + 1), taps in HWIO order (k = (ky·3 + kx)·c + ci), so an HWIO
    kernel reshaped to (9c, cout) is the matching weight matrix."""
    n, h, w, _ = x.shape
    oh, ow = (h - 1) // stride + 1, (w - 1) // stride + 1
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, ky:ky + stride * (oh - 1) + 1:stride,
                         kx:kx + stride * (ow - 1) + 1:stride]
                      for ky in range(3) for kx in range(3)], dim=-1)


def qconv_acc(t8: torch.Tensor, kernel_q: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """s8 NHWC × s8 HWIO kernel → s32 NHWC: 1×1 at stride 1, or 3×3 at stride 1 or 2
    with padding 1."""
    kh, kw, cin, cout = kernel_q.shape
    if kh == 1 and kw == 1 and stride == 1:
        cols = t8
    elif kh == 3 and kw == 3:
        cols = im2col3x3(t8, stride)
    else:
        raise ValueError(f"no s8 conv for a {kh}×{kw} kernel at stride {stride}")
    n, h, w, k = cols.shape
    out = qmm(cols.reshape(n * h * w, k), kernel_q.reshape(kh * kw * cin, cout))
    return out.reshape(n, h, w, cout)


def requant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 → s8 on the per-tensor `scale`: x / scale + 0.5, clip to [0, 127] (the relu
    folds into the clip at 0), truncating convert — round half up."""
    return torch.clamp(x / scale + 0.5, 0.0, QMAX).to(torch.int8)


def requant_signed(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Signed variant for the conv shortcut's output: round half away from zero."""
    y = x / scale
    y = torch.where(y >= 0, y + 0.5, y - 0.5)
    return torch.clamp(y, -QMAX, QMAX).to(torch.int8)


def avg_pool_int8(x8: torch.Tensor, window: int) -> torch.Tensor:
    """Exact integer window×window mean-pool of an NHWC s8 tensor (stride = window,
    trailing rows/columns dropped): s32 sum, then (sum + n//2) floor-divided by n."""
    n_img, h, w, c = x8.shape
    h2, w2 = h // window, w // window
    x = x8[:, :h2 * window, :w2 * window].to(torch.int32)
    s = x.reshape(n_img, h2, window, w2, window, c).sum(dim=(2, 4))
    n = window * window
    return torch.div(s + n // 2, n, rounding_mode="floor").to(torch.int8)


def max_pool_int8(x8: torch.Tensor, window: int = 3, stride: int = 2,
                  pad: int = 1) -> torch.Tensor:
    """torchvision's stem max pool on an NHWC s8 tensor, padded with -128
    (`quantize.py:79-86`): exact, since max commutes with the monotone requant."""
    n, h, w, c = x8.shape
    oh, ow = (h + 2 * pad - window) // stride + 1, (w + 2 * pad - window) // stride + 1
    xp = F.pad(x8, (0, 0, pad, pad, pad, pad), value=-128)
    out = None
    for ky in range(window):
        for kx in range(window):
            tap = xp[:, ky:ky + stride * (oh - 1) + 1:stride,
                     kx:kx + stride * (ow - 1) + 1:stride]
            out = tap if out is None else torch.maximum(out, tap)
    return out
