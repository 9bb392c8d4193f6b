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

The requants take `recip`: the JAX package's `ECT_RECIP_REQUANT=1` form
(`embodied_clip_tpu/ops/quantize.py:100-113`), x · (1 / scale) in place of x / scale.
The reciprocal is an f32 division of device tensors (the correctly rounded 1/s, which
the kernels compute as `__frcp_rn`), and the product is rounded on its own before the
± 0.5. XLA on the CPU contracts that product and the + 0.5 into one fused multiply-add,
but the s8 result cannot tell: fl is monotone and k - 0.5 is an f32 value for every k ≤
127, so trunc(fl(fl(p) + 0.5)) = trunc(fl(p + 0.5)) for every product p ≥ 0, and
likewise for the signed requant (`tests/test_torch_quant_variants.py` shows both).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["QMAX", "QMAX4", "qmm", "qconv_acc", "unscale", "requant", "requant_signed",
           "requant_u4", "requant_s4", "avg_pool_int8", "max_pool_int8", "im2col3x3",
           "full_f32"]

QMAX = 127.0
QMAX4 = 7.0
# scale8 → scale4 of the 4-bit grid: 127/7 rounded to f32 first, as the JAX package's
# weak-typed multiply of an f32 scale by the Python float does.
_WIDEN4 = float(np.float32(QMAX / QMAX4))


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


def unscale(x: torch.Tensor, scale: torch.Tensor, recip: bool = False) -> torch.Tensor:
    """x / scale; with `recip`, x · (1 / scale), the reciprocal an f32 division of
    device tensors."""
    if recip:
        return x * (torch.ones_like(scale) / scale)
    return x / scale


def requant(x: torch.Tensor, scale: torch.Tensor, recip: bool = False,
            qmax: float = QMAX) -> torch.Tensor:
    """f32 → s8 on the per-tensor `scale`: x / scale + 0.5, clip to [0, qmax] (the relu
    folds into the clip at 0), truncating convert — round half up."""
    return torch.clamp(unscale(x, scale, recip) + 0.5, 0.0, qmax).to(torch.int8)


def requant_signed(x: torch.Tensor, scale: torch.Tensor, recip: bool = False,
                   qmax: float = QMAX) -> torch.Tensor:
    """Signed variant for the conv shortcut's output: round half away from zero."""
    y = unscale(x, scale, recip)
    y = torch.where(y >= 0, y + 0.5, y - 0.5)
    return torch.clamp(y, -qmax, qmax).to(torch.int8)


def requant_u4(x: torch.Tensor, scale8: torch.Tensor, recip: bool = False):
    """f32 (post-relu) → (q, scale4): `requant` on the 4-bit grid of the same calibrated
    maximum, scale4 = scale8 · 127/7, values clipped to [0, 7] (`quantize.py:128-136`).
    q is an s8 tensor holding the 4-bit values: torch has no 4-bit type the graph could
    store, and every consumer widens the JAX package's s4 to s8 anyway."""
    s4 = scale8 * _WIDEN4
    return requant(x, s4, recip, QMAX4), s4


def requant_s4(x: torch.Tensor, scale8: torch.Tensor, recip: bool = False):
    """Signed `requant_u4` for the shortcut outputs: values clipped to [-7, 7]."""
    s4 = scale8 * _WIDEN4
    return requant_signed(x, s4, recip, QMAX4), s4


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
