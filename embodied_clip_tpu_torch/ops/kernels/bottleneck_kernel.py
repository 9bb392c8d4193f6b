"""Kernels K3, K4 and K5: the int8 bottlenecks of the quantized CLIP trunk.

Replaces, in `embodied_clip_tpu/ops/pallas/bottleneck_kernel.py`:
  K3 `fused_stage1_int8`     the whole int8 stage 1 (3 bottlenecks, bf16 shortcut)
  K4 `fused_cb3_cb1_int8`    block n's cb3 + residual + requant with block n+1's cb1
  K5 `fused_resblocks_int8`  k stride-1 identity bottlenecks
Each has the TPU kernel's signature and result. The CUDA source is
`embodied_clip_tpu_torch/csrc/bottleneck_int8.cu`; its header states the bound and the
design. A stage does not fit one SM's shared memory as it fits a TPU core's VMEM, so
K3 and K5 are short sequences of launches through one set of device functions:

  K4  1 launch   cb3_cb1 (c)
  K5  2k+1       cb1 (a), then per block: 3×3 cb2 (b), and cb3 + residual + requant
                 fused with the next block's cb1 (c); the last block's cb3 is (a) with
                 the residual epilogue (s8 requant, or the relu'd bf16/f32 conv map)
  K3  8          cb1a (a), shortcut (d), cb2a (b), cb3a·cb1b (c), cb2b (b), cb3b·cb1c
                 (c), cb2c (b), cb3c + residual + requant (a)

Every wrapper takes its plain version for a CPU tensor, and only for a CPU tensor;
on a CUDA tensor it launches or raises. Each counts its calls that launch (`.launches`),
once per call, whatever the number of launches inside. The plain versions use the
int8 graph's primitives (`ops/int8.py`) in the TPU kernels' op order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence

import torch

from embodied_clip_tpu_torch.ops.int8 import full_f32, qconv_acc, qmm, requant, requant_signed

__all__ = ["fused_stage1_int8", "fused_cb3_cb1_int8", "fused_resblocks_int8",
           "fused_stage1_int8_reference", "fused_cb3_cb1_int8_reference",
           "fused_resblocks_int8_reference"]

_SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block can opt in to
_OUT_KIND = {torch.int8: 1, torch.bfloat16: 2, torch.float32: 3}  # residual epilogues


# ------------------------------------------------------------------ plain versions


def _affine(acc: torch.Tensor, s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return acc.float() * s + b


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def _pw(x8: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """1×1 s8 conv as a row product: NHWC s8 × (Cin, Cout) s8 → NHWC s32."""
    return qmm(_rows(x8), k).reshape(*x8.shape[:-1], k.shape[-1])


def _shortcut_reference(x8, wsc, bsc, s_in, dsc):
    """K3's conv shortcut: bf16(x8·s_in) · wsc in f32 (TF32 off) + bsc → signed s8."""
    x0 = (x8.float() * s_in).to(torch.bfloat16).float()
    with full_f32():
        sc = torch.matmul(x0, wsc.float())
    return requant_signed(sc + bsc, dsc)


def fused_cb3_cb1_int8_reference(x8, res8, ops):
    """Plain version of K4: (out8 on r_out, y8 on r_next)."""
    scl = ops["scl"]
    out = _affine(_pw(x8, ops["k3"]), ops["s3"], ops["b3"]) + res8.float() * scl[0]
    out8 = requant(out, scl[1])
    y8 = requant(_affine(_pw(out8, ops["k1"]), ops["s1"], ops["b1"]), scl[2])
    return out8, y8


def fused_resblocks_int8_reference(x8, block_ops, scl, out_dtype=torch.int8):
    """Plain version of K5: k identity bottlenecks on scl = [r_in, (r2, r3, r_out)×k]."""
    xq = x8
    for i, blk in enumerate(block_ops):
        r_in = scl[0] if i == 0 else scl[3 * i]
        q1 = requant(_affine(_pw(xq, blk["k1"]), blk["s1"], blk["b1"]), scl[3 * i + 1])
        q2 = requant(_affine(qconv_acc(q1, blk["k2"]), blk["s2"], blk["b2"]),
                     scl[3 * i + 2])
        y3 = _affine(_pw(q2, blk["k3"]), blk["s3"], blk["b3"])
        out = torch.relu(y3 + xq.float() * r_in)
        if i < len(block_ops) - 1:
            xq = requant(out, scl[3 * i + 3])
    if out_dtype == torch.int8:
        return requant(out, scl[3 * len(block_ops)])
    return out.to(out_dtype)


def fused_stage1_int8_reference(x8, ops):
    """Plain version of K3: int8 stage 1, output on stage 2's input scale."""
    scl = ops["scl"]  # [s_in, r2a, r3a, r_outa, r2b, r3b, r_outb, r2c, r3c, r_outc, dsc]
    x = x8
    for b, L in enumerate("abc"):
        r2, r3, r_out = scl[3 * b + 1], scl[3 * b + 2], scl[3 * b + 3]
        q1 = requant(_affine(_pw(x, ops[f"k1{L}"]), ops[f"s1{L}"], ops[f"b1{L}"]), r2)
        q2 = requant(_affine(qconv_acc(q1, ops[f"k2{L}"]), ops[f"s2{L}"], ops[f"b2{L}"]), r3)
        y = _affine(_pw(q2, ops[f"k3{L}"]), ops[f"s3{L}"], ops[f"b3{L}"])
        if b == 0:
            res8, r_res = _shortcut_reference(x, ops["wsc"], ops["bsc"], scl[0], scl[10]), scl[10]
        else:
            res8, r_res = x, scl[3 * b]
        x = requant(y + res8.float() * r_res, r_out)
    return x


# ---------------------------------------------------------------------- the library


@functools.lru_cache(maxsize=1)
def _lib():
    from embodied_clip_tpu_torch.ops.kernels import _build

    lib = _build.load("bottleneck_int8")
    p, i = ctypes.c_void_p, ctypes.c_int
    sig = {
        "ect_conv1x1_s8": [p, i, i, p, i, p, p, p, p, p, p, i, i, p],
        "ect_conv3x3_s8": [p, i, i, i, i, p, i, p, p, p, p, i, p],
        "ect_cb3_cb1_s8": [p, p, i, i, i, i] + [p] * 11 + [i, i, p],
        "ect_shortcut_bf16": [p, p, i, i, i, p, p, p, p, i, p],
    }
    for name, args in sig.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    lib.ect_cb3_cb1_smem_bytes.argtypes = [i, i, i]
    lib.ect_cb3_cb1_smem_bytes.restype = ctypes.c_size_t
    lib.ect_error_string.argtypes = [ctypes.c_int]
    lib.ect_error_string.restype = ctypes.c_char_p
    return lib


def _call(fn, *args) -> None:
    err = fn(*args)
    if err:
        raise RuntimeError(f"{fn.__name__} launch failed: "
                           + _lib().ect_error_string(err).decode())


def _ptr(t: torch.Tensor, i: int = 0) -> int:
    """Device address of element i of a contiguous f32 vector (a scale of scl)."""
    return t.data_ptr() + 4 * i


def _stream(t: torch.Tensor):
    return t.device.index or 0, torch.cuda.current_stream(t.device).cuda_stream


def _check_s8(name: str, t: torch.Tensor, device) -> None:
    if t.dtype != torch.int8 or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous int8 tensor on {device}, got "
                         f"{t.dtype} on {t.device}")
    if t.shape[-1] % 4 or t.data_ptr() % 16:
        raise ValueError(f"{name}: the last dim must be a multiple of 4 and the data "
                         f"16-byte aligned, got {tuple(t.shape)}")


def _check_f32(name: str, t: torch.Tensor, device, n: int) -> None:
    if (t.dtype != torch.float32 or t.device != device or not t.is_contiguous()
            or t.numel() != n):
        raise ValueError(f"{name}: expected {n} contiguous float32 values on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _cuda_input(kernel: str, x8: torch.Tensor) -> bool:
    """True for a CPU tensor (take the plain version); raise unless a CUDA s8 tensor."""
    if x8.device.type == "cpu":
        return True
    if x8.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {x8.device}")
    _check_s8(kernel, x8, x8.device)
    if x8.ndim != 4:
        raise ValueError(f"{kernel}: expected NHWC, got {tuple(x8.shape)}")
    return False


def _conv1x1(x8, k, s, b, r_out_ptr, out, res=None, r_res_ptr=None):
    """(a): out = epilogue(x8 · k); s8 requant, or the residual epilogues."""
    dev = x8.device
    cin, cout = k.shape
    if (x8.shape[-1] != cin or out.shape != (*x8.shape[:-1], cout)
            or (res is not None and res.shape != out.shape)):
        raise ValueError(f"1x1: shapes x8 {tuple(x8.shape)}, k {tuple(k.shape)}, out "
                         f"{tuple(out.shape)} do not chain")
    _check_s8("1x1 kernel", k, dev)
    _check_f32("1x1 scale", s, dev, cout)
    _check_f32("1x1 bias", b, dev, cout)
    if res is None:
        kind = 0
    else:
        _check_s8("residual", res, dev)
        kind = _OUT_KIND[out.dtype]
    _call(_lib().ect_conv1x1_s8, x8.data_ptr(), x8.numel() // cin, cin, k.data_ptr(), cout,
          s.data_ptr(), b.data_ptr(), 0 if res is None else res.data_ptr(),
          r_res_ptr or 0, r_out_ptr, out.data_ptr(), kind, *_stream(x8))


def _conv3x3(x8, k2, s, b, r_out_ptr, out):
    """(b): out = requant(conv3x3(x8, k2)·s + b) for an HWIO (3, 3, C, Cout) kernel."""
    dev = x8.device
    n, h, w, c = x8.shape
    cout = k2.shape[-1]
    if tuple(k2.shape[:3]) != (3, 3, c):
        raise ValueError(f"3x3 kernel: expected (3, 3, {c}, Cout), got {tuple(k2.shape)}")
    _check_s8("3x3 kernel", k2, dev)
    _check_f32("3x3 scale", s, dev, cout)
    _check_f32("3x3 bias", b, dev, cout)
    _call(_lib().ect_conv3x3_s8, x8.data_ptr(), n, h, w, c, k2.data_ptr(), cout,
          s.data_ptr(), b.data_ptr(), r_out_ptr, out.data_ptr(), *_stream(x8))


def _cb3_cb1(x8, res8, k3, s3, b3, k1, s1, b1, r_res_ptr, r_out_ptr, r_next_ptr):
    """(c): one launch; returns (out8 (…, C), y8 (…, C1))."""
    dev = x8.device
    cm, c = k3.shape
    c1 = k1.shape[-1]
    if res8.shape[:-1] != x8.shape[:-1] or res8.shape[-1] != c or k1.shape[0] != c:
        raise ValueError(f"cb3·cb1: shapes x8 {tuple(x8.shape)}, res8 {tuple(res8.shape)}, "
                         f"k3 {tuple(k3.shape)}, k1 {tuple(k1.shape)} do not chain")
    for nm, t in (("residual", res8), ("cb3 kernel", k3), ("cb1 kernel", k1)):
        _check_s8(nm, t, dev)
    for nm, t, n in (("cb3 scale", s3, c), ("cb3 bias", b3, c), ("cb1 scale", s1, c1),
                     ("cb1 bias", b1, c1)):
        _check_f32(nm, t, dev, n)
    lib = _lib()
    m = x8.numel() // cm
    rows = 64 if (m + 63) // 64 >= 264 else 32
    if lib.ect_cb3_cb1_smem_bytes(rows, cm, c) > _SMEM_LIMIT:
        rows = 32
    if lib.ect_cb3_cb1_smem_bytes(rows, cm, c) > _SMEM_LIMIT:
        raise ValueError(f"cb3·cb1: Cm={cm}, C={c} needs more shared memory than "
                         f"{_SMEM_LIMIT} B")
    out8 = torch.empty((*x8.shape[:-1], c), dtype=torch.int8, device=dev)
    y8 = torch.empty((*x8.shape[:-1], c1), dtype=torch.int8, device=dev)
    _call(lib.ect_cb3_cb1_s8, x8.data_ptr(), res8.data_ptr(), m, cm, c, c1,
          k3.data_ptr(), s3.data_ptr(), b3.data_ptr(), k1.data_ptr(), s1.data_ptr(),
          b1.data_ptr(), r_res_ptr, r_out_ptr, r_next_ptr, out8.data_ptr(), y8.data_ptr(),
          rows, *_stream(x8))
    return out8, y8


# ------------------------------------------------------------------------ wrappers


def fused_cb3_cb1_int8(x8: torch.Tensor, res8: torch.Tensor, ops: Dict[str, torch.Tensor]):
    """Block n's cb3 + residual + requant fused with block n+1's cb1 + requant.

    x8 (N, H, W, Cm) s8: block n's cb2 output; res8 (N, H, W, C) s8 on scl[0]; ops
    from `ops/quantize.cb3_cb1_operands`: k3 (Cm, C), s3/b3 (C,), k1 (C, C1), s1/b1
    (C1,), scl = [r_res, r_out, r_next]. Returns (out8 (N, H, W, C) on r_out, y8 (N, H,
    W, C1) on r_next). Bit-exact against the plain version."""
    if _cuda_input("fused_cb3_cb1_int8", x8):
        return fused_cb3_cb1_int8_reference(x8, res8, ops)
    scl = ops["scl"]
    _check_f32("scl", scl, x8.device, 3)
    out = _cb3_cb1(x8, res8, ops["k3"], ops["s3"], ops["b3"], ops["k1"], ops["s1"],
                   ops["b1"], _ptr(scl, 0), _ptr(scl, 1), _ptr(scl, 2))
    fused_cb3_cb1_int8.launches += 1
    return out


def fused_resblocks_int8(x8: torch.Tensor, block_ops: Sequence[Dict[str, torch.Tensor]],
                         scl: torch.Tensor, out_dtype=torch.int8) -> torch.Tensor:
    """k consecutive stride-1 identity int8 bottlenecks.

    x8 (N, H, W, C) s8 on scl[0]; block_ops from `ops/quantize.resblocks_int8_operands`:
    per block k1 (C, Cm), s1, b1, k2 (3, 3, Cm, Cm), s2, b2, k3 (Cm, C), s3, b3; scl
    (3k+1,) = [r_in, (r2, r3, r_out) × k]. Returns (N, H, W, C): s8 requantized on the
    last r_out, or, for `out_dtype` bf16/f32, the trunk's final conv map (relu'd, no
    requant). Bit-exact against the plain version."""
    if _cuda_input("fused_resblocks_int8", x8):
        return fused_resblocks_int8_reference(x8, block_ops, scl, out_dtype)
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"fused_resblocks_int8 writes int8, bfloat16 or float32, "
                         f"not {out_dtype}")
    nb = len(block_ops)
    _check_f32("scl", scl, x8.device, 3 * nb + 1)
    dev = x8.device
    shape, cm = x8.shape[:-1], block_ops[0]["k1"].shape[-1]
    q1 = torch.empty((*shape, cm), dtype=torch.int8, device=dev)
    first = block_ops[0]
    _conv1x1(x8, first["k1"], first["s1"], first["b1"], _ptr(scl, 1), q1)
    xq = x8
    for i, blk in enumerate(block_ops):
        q2 = torch.empty((*shape, blk["k2"].shape[-1]), dtype=torch.int8, device=dev)
        _conv3x3(q1, blk["k2"], blk["s2"], blk["b2"], _ptr(scl, 3 * i + 2), q2)
        r_res = _ptr(scl, 0 if i == 0 else 3 * i)
        if i < nb - 1:
            nxt = block_ops[i + 1]
            xq, q1 = _cb3_cb1(q2, xq, blk["k3"], blk["s3"], blk["b3"], nxt["k1"],
                              nxt["s1"], nxt["b1"], r_res, _ptr(scl, 3 * i + 3),
                              _ptr(scl, 3 * i + 4))
        else:
            out = torch.empty(x8.shape, dtype=out_dtype, device=dev)
            _conv1x1(q2, blk["k3"], blk["s3"], blk["b3"], _ptr(scl, 3 * nb), out,
                     res=xq, r_res_ptr=r_res)
    fused_resblocks_int8.launches += 1
    return out


def fused_stage1_int8(x8: torch.Tensor, ops: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The whole int8 CLIP-RN50 stage 1: x8 (N, H, W, Cin) s8 on the stem.out scale,
    ops from `ops/quantize.stage1_int8_operands`. Returns (N, H, W, Cout) s8 already
    requantized to stage 2's input scale. Matches the plain version up to ±1 s8 step
    on a small fraction of elements: the bf16 shortcut's f32 sum is the one
    non-integer reduction, and its order differs."""
    if _cuda_input("fused_stage1_int8", x8):
        return fused_stage1_int8_reference(x8, ops)
    scl = ops["scl"]
    dev = x8.device
    _check_f32("scl", scl, dev, 11)
    wsc, bsc = ops["wsc"], ops["bsc"]
    cin, cout = wsc.shape
    if (wsc.dtype != torch.bfloat16 or wsc.device != dev or not wsc.is_contiguous()
            or x8.shape[-1] != cin):
        raise ValueError(f"fused_stage1_int8: wsc must be a contiguous bf16 ({x8.shape[-1]}, "
                         f"Cout) tensor on {dev}, got {wsc.dtype} {tuple(wsc.shape)}")
    _check_f32("bsc", bsc, dev, cout)
    shape = x8.shape[:-1]
    m = x8.numel() // cin
    cm = ops["k1a"].shape[-1]

    def s8(c):
        return torch.empty((*shape, c), dtype=torch.int8, device=dev)

    q1 = s8(cm)
    _conv1x1(x8, ops["k1a"], ops["s1a"], ops["b1a"], _ptr(scl, 1), q1)
    sc8 = s8(cout)
    _call(_lib().ect_shortcut_bf16, x8.data_ptr(), wsc.data_ptr(), m, cin, cout,
          _ptr(scl, 0), bsc.data_ptr(), _ptr(scl, 10), sc8.data_ptr(), *_stream(x8))
    res8, r_res = sc8, _ptr(scl, 10)
    for b, L in enumerate("abc"):
        q2 = s8(cm)
        _conv3x3(q1, ops[f"k2{L}"], ops[f"s2{L}"], ops[f"b2{L}"], _ptr(scl, 3 * b + 2), q2)
        if L != "c":
            nx = "abc"[b + 1]
            res8, q1 = _cb3_cb1(q2, res8, ops[f"k3{L}"], ops[f"s3{L}"], ops[f"b3{L}"],
                                ops[f"k1{nx}"], ops[f"s1{nx}"], ops[f"b1{nx}"], r_res,
                                _ptr(scl, 3 * b + 3), _ptr(scl, 3 * b + 4))
            r_res = _ptr(scl, 3 * b + 3)
        else:
            out = s8(cout)
            _conv1x1(q2, ops["k3c"], ops["s3c"], ops["b3c"], _ptr(scl, 9), out,
                     res=res8, r_res_ptr=r_res)
    fused_stage1_int8.launches += 1
    return out


fused_stage1_int8.launches = 0
fused_cb3_cb1_int8.launches = 0
fused_resblocks_int8.launches = 0
