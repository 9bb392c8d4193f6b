"""Kernel K2: stem3 3×3 conv + requant + exact 2×2 int8 mean-pool.

Replaces `embodied_clip_tpu/ops/pallas/stem_kernel.py:stem3_requant_pool_int8`. The
CUDA source is `embodied_clip_tpu_torch/csrc/stem_int8.cu`; its header states the
bound and the design. This module holds

  - `stem3_requant_pool_int8`: the wrapper. A CUDA tensor launches the kernel (or
    raises); a CPU tensor, and only a CPU tensor, takes the plain version;
  - `stem3_requant_pool_int8_reference`: the plain version, K2's own math (bf16
    operands, f32 accumulation, no bf16 rounding of the conv output) in torch;
  - `stem3_weight_matrix`: the kernel's weights in the layout it reads, which
    `ops/quantize.py` builds once and caches.

The kernel takes Cin 8, 32 or 48 (the width-16 trunk, RN50, RN50x16) and Cout 16, 64
or 96. `recip=True` selects the reciprocal requant (`ops/int8.py`), in the plain version
and in the kernel, whose source instantiates both forms.
`stem3_requant_pool_int8.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from embodied_clip_tpu_torch.ops.int8 import avg_pool_int8, full_f32, requant

__all__ = ["stem3_requant_pool_int8", "stem3_requant_pool_int8_reference",
           "stem3_weight_matrix"]

CIN_WIDTHS, COUT_WIDTHS = (8, 32, 48), (16, 64, 96)


def _scale_tensor(scale, device) -> torch.Tensor:
    return torch.as_tensor(scale, dtype=torch.float32, device=device).reshape(())


def _padded_k(cin: int):
    """(Cp, Kp): Cin rounded up to a multiple of 16 (one k16 step), 9·Cp to one of 64."""
    cp = -(-cin // 16) * 16
    return cp, -(-9 * cp // 64) * 64


def stem3_weight_matrix(kernel: torch.Tensor) -> torch.Tensor:
    """The (Cout, Kp) K-major bf16 weights the kernel reads for an HWIO (3, 3, Cin, Cout)
    kernel: k = (ky·3 + kx)·Cp + c, zero at c ≥ Cin and at k ≥ 9·Cp (`_padded_k`)."""
    cin, cout = kernel.shape[2], kernel.shape[3]
    cp, kp = _padded_k(cin)
    w = F.pad(kernel.to(torch.bfloat16).permute(3, 0, 1, 2), (0, cp - cin))
    return F.pad(w.reshape(cout, 9 * cp), (0, kp - 9 * cp)).contiguous()


def stem3_requant_pool_int8_reference(x: torch.Tensor, kernel: torch.Tensor,
                                      bias: torch.Tensor, scale,
                                      recip: bool = False) -> torch.Tensor:
    """Plain version of K2 on any device: x (N, H, W, Cin) bf16, kernel (3, 3, Cin,
    Cout) HWIO, bias (Cout,), scale the stem.out activation scale → (N, H/2, W/2,
    Cout) s8 = avg_pool_int8(requant(conv(x, bf16(kernel)) + bias, scale, recip), 2)."""
    w = kernel.to(torch.bfloat16).float().permute(3, 2, 0, 1)
    with full_f32():
        y = torch.nn.functional.conv2d(x.float().permute(0, 3, 1, 2), w, padding=1)
    y = y.permute(0, 2, 3, 1) + bias.float()
    return avg_pool_int8(requant(y, _scale_tensor(scale, x.device), recip), 2)


@functools.lru_cache(maxsize=1)
def _lib():
    from embodied_clip_tpu_torch.ops.kernels import _build

    lib = _build.load("stem_int8")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ect_stem3_requant_pool.argtypes = [p] * 5 + [i] * 6 + [i, p]
    lib.ect_stem3_requant_pool.restype = ctypes.c_int
    lib.ect_error_string.argtypes = [ctypes.c_int]
    lib.ect_error_string.restype = ctypes.c_char_p
    return lib


def stem3_requant_pool_int8(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                            scale, wmat: torch.Tensor | None = None,
                            recip: bool = False) -> torch.Tensor:
    """x (N, H, W, Cin) bf16 (stem2's output), kernel (3, 3, Cin, Cout), bias (Cout,),
    scale the stem.out scale → the requantized, 2×2-mean-pooled stem output (N, H/2,
    W/2, Cout) s8, in one launch. `wmat` is `stem3_weight_matrix(kernel)` built once by
    the caller (ops/quantize.py caches it); without it the wrapper builds it per call.
    `recip` selects the reciprocal requant. A CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return stem3_requant_pool_int8_reference(x, kernel, bias, scale, recip)
    if x.device.type != "cuda":
        raise ValueError(f"stem3 kernel: no kernel for device {x.device}")
    if x.dtype != torch.bfloat16 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError("stem3 kernel expects a contiguous bf16 (N, H, W, Cin) tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    n, h, w, cin = x.shape
    if tuple(kernel.shape[:3]) != (3, 3, cin):
        raise ValueError(f"stem3 kernel expects a (3, 3, {cin}, Cout) kernel, got "
                         f"{tuple(kernel.shape)}")
    cout = kernel.shape[3]
    if cin not in CIN_WIDTHS or cout not in COUT_WIDTHS:
        raise ValueError(f"stem3 kernel takes Cin in {CIN_WIDTHS} and Cout in {COUT_WIDTHS}, "
                         f"got Cin = {cin}, Cout = {cout}")
    if h % 2 or w % 2:
        raise ValueError(f"stem3 kernel pools 2×2: H and W must be even, got {h}×{w}")
    if wmat is None:
        wmat = stem3_weight_matrix(kernel.to(x.device))
    elif (wmat.dtype != torch.bfloat16 or wmat.device != x.device or not wmat.is_contiguous()
          or tuple(wmat.shape) != (cout, _padded_k(cin)[1])):
        raise ValueError(f"stem3 kernel: wmat must be stem3_weight_matrix(kernel) on "
                         f"{x.device}, got {wmat.dtype} {tuple(wmat.shape)}")
    b = bias.to(device=x.device, dtype=torch.float32).contiguous()
    s = _scale_tensor(scale, x.device)
    out = torch.empty((n, h // 2, w // 2, cout), dtype=torch.int8, device=x.device)
    if n == 0:
        return out
    lib = _lib()
    err = lib.ect_stem3_requant_pool(
        x.data_ptr(), wmat.data_ptr(), b.data_ptr(), s.data_ptr(), out.data_ptr(),
        n, h, w, cin, cout, int(recip), x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("stem3 kernel launch failed: " + lib.ect_error_string(err).decode())
    stem3_requant_pool_int8.launches += 1
    return out


stem3_requant_pool_int8.launches = 0
