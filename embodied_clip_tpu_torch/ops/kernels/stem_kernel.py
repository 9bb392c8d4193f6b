"""The int8 CLIP trunk's stem: kernel K2 (stem3 3×3 conv + requant + exact 2×2 int8
mean-pool) and the stem12 launch (stem1 + stem2 in f32 FMA) ahead of it.

K2 replaces `embodied_clip_tpu/ops/pallas/stem_kernel.py:stem3_requant_pool_int8`; stem12
replaces no TPU kernel (the JAX package leaves stem1 and stem2 to XLA's f32 convs). The
CUDA source of both is `embodied_clip_tpu_torch/csrc/stem_int8.cu`; its header notes state
their bounds and designs. This module holds

  - `stem3_requant_pool_int8`, `stem12_f32`: the wrappers. A CUDA tensor launches the
    kernel (or raises); a CPU tensor, and only a CPU tensor, takes the plain version;
  - `stem3_requant_pool_int8_reference`: K2's plain version, its own math (bf16
    operands, f32 accumulation, no bf16 rounding of the conv output) in torch;
  - `stem12_f32_reference`: stem12's plain version, the int8 graph's own stem1 → stem2
    route (`ops/quantize._fp_conv` twice), then the cast K2 reads;
  - `stem3_weight_matrix`, `stem12_weights`: the kernels' weights in the layouts they
    read, which `ops/quantize.py` builds once and caches.

K2 takes Cin 8, 32 or 48 (the width-16 trunk, RN50, RN50x16) and Cout 16, 64 or 96;
stem12 the same stem widths C (3 → C → C) on any (N, H, W, 3) frames. `recip=True` selects K2's
reciprocal requant (`ops/int8.py`), in the plain version and in the kernel, whose source
instantiates both forms. Each wrapper's `.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from embodied_clip_tpu_torch.ops.int8 import avg_pool_int8, full_f32, requant
from embodied_clip_tpu_torch.ops.kernels._build import Library, stream

__all__ = ["stem3_requant_pool_int8", "stem3_requant_pool_int8_reference",
           "stem3_weight_matrix", "stem12_f32", "stem12_f32_reference", "stem12_weights",
           "STEM12_WIDTHS"]

CIN_WIDTHS, COUT_WIDTHS = (8, 32, 48), (16, 64, 96)
STEM12_WIDTHS = CIN_WIDTHS  # stem1's and stem2's C: the stem widths K2 takes


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


_p, _i = ctypes.c_void_p, ctypes.c_int
LIB = Library("stem_int8", {"ect_stem3_requant_pool": [_p] * 5 + [_i] * 6 + [_i, _p],
                            "ect_stem12_f32": [_p, _i] + [_p] * 5 + [_i] * 5 + [_p]})


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
    LIB.ect_stem3_requant_pool(x.data_ptr(), wmat.data_ptr(), b.data_ptr(), s.data_ptr(),
                               out.data_ptr(), n, h, w, cin, cout, int(recip), *stream(x))
    stem3_requant_pool_int8.launches += 1
    return out


stem3_requant_pool_int8.launches = 0


# ---------------------------------------------------------------------------- stem12


def stem12_weights(k1: torch.Tensor, b1: torch.Tensor, k2: torch.Tensor,
                   b2: torch.Tensor) -> dict:
    """The operands the stem12 launch reads, for HWIO kernels k1 (3, 3, 3, C) and k2 (3,
    3, C, C): "w1" (27, C) and "w2" (9·C, C), the kernels' bf16-rounded values as f32 in
    rows (ky·3 + kx)·Cin + ci; "b1", "b2" (C,) f32; all contiguous on the kernels' device."""
    c = k1.shape[-1]
    return {"w1": k1.to(torch.bfloat16).float().reshape(27, c).contiguous(),
            "b1": b1.float().contiguous(),
            "w2": k2.to(torch.bfloat16).float().reshape(9 * c, c).contiguous(),
            "b2": b2.float().contiguous()}


def stem12_f32_reference(x: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor,
                         k2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain version of stem12 on any device: x (N, H, W, 3) → (N, ⌈H/2⌉, ⌈W/2⌉, C) bf16 =
    bf16(relu(conv(relu(conv(x, k1, stride 2) + b1), k2) + b2)), each conv of the
    bf16-rounded operands in full f32: the int8 graph's own stem1 → stem2 route
    (`ops/quantize._fp_conv` twice), then the cast K2 reads."""
    from embodied_clip_tpu_torch.ops import quantize as Q  # Q imports this module

    q = {"fp": {"stem1": {"kernel": k1, "bias": b1}, "stem2": {"kernel": k2, "bias": b2}}}
    return Q._fp_conv(q, "stem2", Q._fp_conv(q, "stem1", x, 2)).to(torch.bfloat16)


def _stem12_frames(x: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, 3) in the form the launch reads, with the same stem1 → stem2 result:
    cast to bf16 unless bf16 or f32 (the cast `_fp_conv` makes), a zero row or column
    added at the bottom or right of an odd H or W (stem1's stride-2 taps read padding
    there), contiguous and 4-byte aligned."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        x = x.to(torch.bfloat16)
    if x.shape[1] % 2 or x.shape[2] % 2:
        x = F.pad(x, (0, 0, 0, x.shape[2] % 2, 0, x.shape[1] % 2))
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 4 else x


def stem12_f32(x: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor, k2: torch.Tensor,
               b2: torch.Tensor, ops: dict | None = None) -> torch.Tensor:
    """x (N, H, W, 3) (the preprocessed frames), k1 (3, 3, 3, C), b1 (C,), k2 (3, 3, C, C),
    b2 (C,) → stem2's bf16 output (N, ⌈H/2⌉, ⌈W/2⌉, C), the input K2 reads, in one launch
    (f32 FMA; see `csrc/stem_int8.cu`). The launch reads contiguous, 4-byte aligned bf16 or
    f32 frames of even H and W; other frames are copied into that form first, with the
    same result (`_stem12_frames`). `ops` is `stem12_weights(k1, b1, k2, b2)` built once by
    the caller (ops/quantize.py caches it); without it the wrapper builds it per call. A
    CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return stem12_f32_reference(x, k1, b1, k2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"stem12 kernel: no kernel for device {x.device}")
    if x.ndim != 4 or x.shape[-1] != 3:
        raise ValueError(f"stem12 kernel expects (N, H, W, 3) frames, got {tuple(x.shape)}")
    c = k1.shape[-1]
    if tuple(k1.shape) != (3, 3, 3, c) or tuple(k2.shape) != (3, 3, c, c):
        raise ValueError(f"stem12 kernel expects (3, 3, 3, C) and (3, 3, C, C) kernels, got "
                         f"{tuple(k1.shape)} and {tuple(k2.shape)}")
    if c not in STEM12_WIDTHS:
        raise ValueError(f"stem12 kernel takes C in {STEM12_WIDTHS}, got C = {c}")
    x = _stem12_frames(x)
    n, h, w, _ = x.shape
    if ops is None:
        ops = stem12_weights(k1.to(x.device), b1.to(x.device), k2.to(x.device),
                             b2.to(x.device))
    shapes = {"w1": (27, c), "b1": (c,), "w2": (9 * c, c), "b2": (c,)}
    for key, shape in shapes.items():
        t = ops.get(key)
        if (t is None or t.dtype != torch.float32 or t.device != x.device
                or not t.is_contiguous() or tuple(t.shape) != shape or t.data_ptr() % 16):
            raise ValueError(f"stem12 kernel: ops must be stem12_weights(...) on {x.device}; "
                             f"{key} is not a contiguous, 16-byte aligned f32 {shape}")
    out = torch.empty((n, h // 2, w // 2, c), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    LIB.ect_stem12_f32(x.data_ptr(), int(x.dtype == torch.float32), ops["w1"].data_ptr(),
                       ops["b1"].data_ptr(), ops["w2"].data_ptr(), ops["b2"].data_ptr(),
                       out.data_ptr(), n, h, w, c, *stream(x))
    stem12_f32.launches += 1
    return out


stem12_f32.launches = 0
