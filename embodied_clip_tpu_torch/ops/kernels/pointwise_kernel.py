"""The per-element chains of the CLIP transformer blocks in bf16, one launch each (the
ViTs' main path on the card): the LayerNorm with its casts (and, for `ln_2`, the residual
add before it), and QuickGELU.

Replaces no TPU kernel: the JAX package leaves both to XLA, and the port's plain route
is `layer_norm_f32(x, ln).to(dtype)` (a bf16 → f32 copy, the f32 LayerNorm, an f32 →
bf16 copy) and `quick_gelu` (three bf16 passes). Both are bound by bytes: at
ViT-L/14@336px's batch 128 the plain chains move 1.36 GB a LayerNorm and 4.2 GB a
QuickGELU against the 302 MB and 1.21 GB that the launches read and write. The CUDA
source is `embodied_clip_tpu_torch/csrc/pointwise_bf16.cu`; its header notes state the
design. This module holds

  - `layer_norm_f32`, `quick_gelu`: the port's precision policy for these functions
    (`models/transformer.py` re-exports them); `quick_gelu` is QuickGELU's plain version;
  - `layer_norm_bf16(x, ln, residual=None)`, `quick_gelu_bf16(y)`: the wrappers. A CUDA
    tensor launches the kernel (or raises); a CPU tensor, and only a CPU tensor, takes
    the plain version. `.launches` counts kernel launches;
  - `layer_norm_plain`: the LayerNorm's plain version, the chain above;
  - `fits`, `kernel_takes`: the launches' shapes and layouts, and whether a caller hands
    a call to them (a CUDA tensor that fits).

Arithmetic: the LayerNorm takes f32 statistics of the bf16 row (its mean, then the mean
of the centred squares, in another order of summation than PyTorch's Welford) and an f32
affine with the f32 weight and bias, rounded once to bf16; with `residual`, the row is
first s = bf16(x + residual), rounded as PyTorch's bf16 add, and s is returned beside
LN(s). QuickGELU is the plain chain's function of each bf16 value, its three roundings
included (bf16(1.702·y), bf16(σ), bf16(y·σ)).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from embodied_clip_tpu_torch.ops.kernels._build import Library, stream

__all__ = ["layer_norm_f32", "quick_gelu", "layer_norm_bf16", "quick_gelu_bf16",
           "layer_norm_plain", "fits", "kernel_takes", "MAX_WIDTH"]

MAX_WIDTH = 4096   # the widest LayerNorm row the kernel holds in one warp's registers


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def layer_norm_f32(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm over the last axis in f32 (its parameters are f32); the result is
    f32."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)


def layer_norm_plain(x: torch.Tensor, ln: nn.LayerNorm, residual: Optional[torch.Tensor] = None,
                     dtype: torch.dtype = torch.bfloat16):
    """`layer_norm_f32(x, ln).to(dtype)`; with `residual`, (s, that of s) for s = x +
    residual."""
    if residual is None:
        return layer_norm_f32(x, ln).to(dtype)
    s = x + residual
    return s, layer_norm_f32(s, ln).to(dtype)


def _like(t: torch.Tensor, x: torch.Tensor) -> bool:
    return (t.device == x.device and t.dtype == torch.bfloat16 and t.shape == x.shape
            and t.is_contiguous() and t.data_ptr() % 16 == 0)


def fits(x: torch.Tensor, residual: Optional[torch.Tensor] = None,
         ln: Optional[nn.LayerNorm] = None) -> bool:
    """The launches' shapes and layouts, on any device: a contiguous, 16-byte-aligned
    bf16 tensor whose last dim is a multiple of 8 (and `residual`, where given, of its
    shape and kind). With `ln`, the LayerNorm's besides: a last dim of 8 to `MAX_WIDTH`
    that `ln` normalises, with f32 weight and bias on the same device."""
    if not (x.ndim >= 1 and x.shape[-1] % 8 == 0 and _like(x, x)):
        return False
    if residual is not None and not _like(residual, x):
        return False
    if ln is None:
        return True
    c = x.shape[-1]
    return (8 <= c <= MAX_WIDTH and tuple(ln.normalized_shape) == (c,)
            and all(p is not None and p.device == x.device and p.dtype == torch.float32
                    and p.is_contiguous() for p in (ln.weight, ln.bias)))


def kernel_takes(x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                 ln: Optional[nn.LayerNorm] = None) -> bool:
    """Whether a caller hands the call to a launch: a CUDA tensor that `fits`."""
    return x.is_cuda and fits(x, residual, ln)


_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIB = Library("pointwise_bf16", {
    "ect_layer_norm_bf16": [_p, _p, _p, _p, _p, _p, _ll, _i, ctypes.c_float, _i, _p],
    "ect_quick_gelu_bf16": [_p, _p, _ll, _i, _p]})


def layer_norm_bf16(x: torch.Tensor, ln: nn.LayerNorm, residual: Optional[torch.Tensor] = None):
    """bf16 (..., C) → LayerNorm over C in bf16, in one launch; with `residual`, (s,
    LN(s)) for s = x + residual, in the same launch. A CPU tensor takes
    `layer_norm_plain`."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, ln, residual)
    if not kernel_takes(x, residual, ln):
        raise ValueError(f"LayerNorm kernel expects contiguous, 16-byte-aligned CUDA bf16 "
                         f"tensors of one shape, the last dim a multiple of 8 up to "
                         f"{MAX_WIDTH}, and f32 affine parameters; got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    y = torch.empty_like(x)
    s = None if residual is None else torch.empty_like(x)
    if x.numel():
        c = x.shape[-1]
        LIB.ect_layer_norm_bf16(
            x.data_ptr(), None if residual is None else residual.data_ptr(),
            None if s is None else s.data_ptr(), y.data_ptr(), ln.weight.data_ptr(),
            ln.bias.data_ptr(), x.numel() // c, c, float(ln.eps), *stream(x))
        layer_norm_bf16.launches += 1
    return y if residual is None else (s, y)


layer_norm_bf16.launches = 0


def quick_gelu_bf16(y: torch.Tensor) -> torch.Tensor:
    """bf16 y → y·σ(1.702·y) in bf16 (the plain chain's roundings), in one launch. A CPU
    tensor takes `quick_gelu`."""
    if y.device.type == "cpu":
        return quick_gelu(y)
    if not kernel_takes(y):
        raise ValueError(f"QuickGELU kernel expects a contiguous, 16-byte-aligned CUDA bf16 "
                         f"tensor whose last dim is a multiple of 8, got {y.dtype} "
                         f"{tuple(y.shape)} on {y.device}")
    out = torch.empty_like(y)
    if y.numel():
        LIB.ect_quick_gelu_bf16(y.data_ptr(), out.data_ptr(), y.numel(), *stream(y))
        quick_gelu_bf16.launches += 1
    return out


quick_gelu_bf16.launches = 0
