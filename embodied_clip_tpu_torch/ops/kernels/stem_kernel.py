"""Kernel K2: stem3 3×3 conv + requant + exact 2×2 int8 mean-pool.

Replaces `embodied_clip_tpu/ops/pallas/stem_kernel.py:stem3_requant_pool_int8`. The
CUDA source is `embodied_clip_tpu_torch/csrc/stem_int8.cu`; its header states the
bound and the design. This module holds

  - `stem3_requant_pool_int8`: the wrapper. A CUDA tensor launches the kernel (or
    raises); a CPU tensor, and only a CPU tensor, takes the plain version;
  - `stem3_requant_pool_int8_reference`: the plain version, K2's own math (bf16
    operands, f32 accumulation, no bf16 rounding of the conv output) in torch.

`stem3_requant_pool_int8.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from embodied_clip_tpu_torch.ops.int8 import avg_pool_int8, full_f32, requant

__all__ = ["stem3_requant_pool_int8", "stem3_requant_pool_int8_reference"]

_SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block can opt in to


def _scale_tensor(scale, device) -> torch.Tensor:
    return torch.as_tensor(scale, dtype=torch.float32, device=device).reshape(())


def stem3_requant_pool_int8_reference(x: torch.Tensor, kernel: torch.Tensor,
                                      bias: torch.Tensor, scale) -> torch.Tensor:
    """Plain version of K2 on any device: x (N, H, W, Cin) bf16, kernel (3, 3, Cin,
    Cout) HWIO, bias (Cout,), scale the stem.out activation scale → (N, H/2, W/2,
    Cout) s8 = avg_pool_int8(requant(conv(x, bf16(kernel)) + bias, scale), 2)."""
    w = kernel.to(torch.bfloat16).float().permute(3, 2, 0, 1)
    with full_f32():
        y = torch.nn.functional.conv2d(x.float().permute(0, 3, 1, 2), w, padding=1)
    y = y.permute(0, 2, 3, 1) + bias.float()
    return avg_pool_int8(requant(y, _scale_tensor(scale, x.device)), 2)


@functools.lru_cache(maxsize=1)
def _lib():
    from embodied_clip_tpu_torch.ops.kernels import _build

    lib = _build.load("stem_int8")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ect_stem3_requant_pool.argtypes = [p] * 5 + [i] * 6 + [i, p]
    lib.ect_stem3_requant_pool.restype = ctypes.c_int
    lib.ect_stem3_smem_bytes.argtypes = [i, i, i]
    lib.ect_stem3_smem_bytes.restype = ctypes.c_size_t
    lib.ect_error_string.argtypes = [ctypes.c_int]
    lib.ect_error_string.restype = ctypes.c_char_p
    return lib


def _span(lib, wp: int, cin: int, cout: int) -> int:
    """Pooled columns per block: all of them where shared memory allows."""
    span = wp
    while lib.ect_stem3_smem_bytes(cin, cout, span) > _SMEM_LIMIT:
        if span == 1:
            raise ValueError(f"stem3 kernel: Cin={cin}, Cout={cout} needs more shared "
                             f"memory than {_SMEM_LIMIT} B")
        span = (span + 1) // 2
    return span


def stem3_requant_pool_int8(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                            scale) -> torch.Tensor:
    """x (N, H, W, Cin) bf16 (stem2's output), kernel (3, 3, Cin, Cout), bias (Cout,),
    scale the stem.out scale → the requantized, 2×2-mean-pooled stem output (N, H/2,
    W/2, Cout) s8, in one launch. A CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return stem3_requant_pool_int8_reference(x, kernel, bias, scale)
    if x.device.type != "cuda":
        raise ValueError(f"stem3 kernel: no kernel for device {x.device}")
    if x.dtype != torch.bfloat16 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError("stem3 kernel expects a contiguous bf16 (N, H, W, Cin) tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    n, h, w, cin = x.shape
    if tuple(kernel.shape[:3]) != (3, 3, cin) or kernel.shape[3] % 4:
        raise ValueError(f"stem3 kernel expects a (3, 3, {cin}, 4k) kernel, got "
                         f"{tuple(kernel.shape)}")
    if h % 2 or w % 2:
        raise ValueError(f"stem3 kernel pools 2×2: H and W must be even, got {h}×{w}")
    cout = kernel.shape[3]
    wmat = kernel.to(device=x.device, dtype=torch.bfloat16).reshape(9 * cin, cout).contiguous()
    b = bias.to(device=x.device, dtype=torch.float32).contiguous()
    s = _scale_tensor(scale, x.device)
    out = torch.empty((n, h // 2, w // 2, cout), dtype=torch.int8, device=x.device)
    if n == 0:
        return out
    lib = _lib()
    err = lib.ect_stem3_requant_pool(
        x.data_ptr(), wmat.data_ptr(), b.data_ptr(), s.data_ptr(), out.data_ptr(),
        n, h, w, cin, cout, _span(lib, w // 2, cin, cout), x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError("stem3 kernel launch failed: " + lib.ect_error_string(err).decode())
    stem3_requant_pool_int8.launches += 1
    return out


stem3_requant_pool_int8.launches = 0
