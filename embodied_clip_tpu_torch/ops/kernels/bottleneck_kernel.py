"""Kernels K3-K7 and the stride blocks: the bottlenecks of the quantized and the folded
bf16 ResNet trunks.

Replaces, in `embodied_clip_tpu/ops/pallas/bottleneck_kernel.py`:
  K3 `fused_stage1_int8`     the whole int8 stage 1 (3 bottlenecks, bf16 shortcut)
  K4 `fused_cb3_cb1_int8`    block n's cb3 + residual + requant with block n+1's cb1
  K5 `fused_resblocks_int8`  k stride-1 identity bottlenecks
  K6 `fused_bottleneck`      one bf16 stride-1 identity bottleneck, BN folded
  K7 `fused_stage1`          the whole bf16 stage 1 (conv shortcut on block 0)
Each has the TPU kernel's signature and result. Beside them, with no TPU kernel (the JAX
package leaves these to XLA's s8 convolutions, `embodied_clip_tpu/ops/quantize.py:545-609`
and `:446-473`):
  `fused_stride_block_int8`  block 0 of stages 2-4: cb1, cb2, the 2×2 pools, the pooled
                             conv shortcut and cb3 + residual + requant
  `conv3x3_int8`             the int8-stem options' s8 3×3 stem convs (and the pool)
  `fused_stride_block_bf16`  CLIP's anti-aliased stride-2 bottleneck of a folded bf16
                             trunk (`embodied_clip_tpu/models/clip_resnet.py`'s block
                             with stride 2, BN folded)
The CUDA sources are `embodied_clip_tpu_torch/csrc/bottleneck_int8.cu` (K3-K5, the
stride blocks, `conv3x3_int8`) and `bottleneck_bf16.cu` (K6, K7, the bf16 stride block);
their headers state the bound and the design. A stage does not fit one SM's
shared memory as it fits a TPU core's VMEM, so each is a short sequence of launches
through a few device functions:

  K4  1 launch   cb3_cb1 (c)
  K5  2k+1       cb1 (a), then per block: 3×3 cb2 (b), and cb3 + residual + requant
                 fused with the next block's cb1 (c); the last block's cb3 is (a) with
                 the residual epilogue (s8 requant, or the relu'd bf16/f32 conv map)
  K3  7          entry (d): cb1a and the bf16 conv shortcut from one read of x8; then
                 cb2a (b), cb3a·cb1b (c), cb2b (b), cb3b·cb1c (c), cb2c (b), cb3c +
                 residual + requant (a)
  K6  3          cb1 (a), 3×3 cb2 (b), cb3 + residual (c), each + bias + relu → bf16
  K7  3 a block  as K6; block 0's cb3 adds the conv shortcut as a second K loop
  stride block 6 cb1 (a) (left out where K4 made it), cb2 (b), the pool (f) of cb2's
                 output, the pool + scale (f') of the block input (bf16 x0 and its rows'
                 norms: the shortcut's A operand, converted once), the conv shortcut (e)
                 on x0, both operands from shared memory, cb3 + residual + requant (a)
                 (left out on path B, where K4 takes cb3)
  bf16 stride block  4  cb1 (a) and 3×3 cb2 (b) at the input's resolution, P (the 2×2
                 pools of cb2's output and of the block input, one launch), cb3 + the
                 pooled conv shortcut (c) in K7's block-0 form

The int8 launches run s8 products on the tensor cores (wgmma), which read both operands
K-major: they take each s8 weight's K-major copy `k…_t`, built once by the operand
builders of `ops/quantize.py`, and C, Cm and N in multiples of 16 (TMA's 16-byte row
strides). K3's conv shortcut runs on bf16 wgmma and reads `wsc` as it is; its entry
launch takes the stage-1 widths of the width-16 trunk, RN50 and RN50x16
(`ENTRY_WIDTHS`). Every wrapper takes its plain version for a CPU tensor, and only for
a CPU tensor; on a CUDA tensor it launches or raises (odd spatial sizes and widths that
are not multiples of 16 included). Each counts its calls that launch (`.launches`), once
per call, whatever the number of launches inside. The int8 plain
versions use the int8 graph's primitives (`ops/int8.py`) in the TPU kernels' op order;
the bf16 ones round to bf16 exactly where the TPU kernels do. The stride shortcut's
near-tie margins per column (`shortcut_margins`) depend only on the fixed weights and
scale: the operand builder computes them once, beside the K-major copies.

The int8 wrappers and plain versions take `recip`, the reciprocal requant (`ops/int8.py`),
at the requants where the TPU kernels call `_unscale`, which `ECT_RECIP_REQUANT=1` turns
into a multiply: both of K4's (`bottleneck_kernel.py:518,533`), K3's three block outputs
(`:290,299,308`), K5's s8 output (`:420`). Their other requants divide under either
setting (K3's cb1/cb2 requants and its shortcut, `:249,258,285`; K5's cb1, cb2 and
inter-block ones, `:383,393,400`), and so do these. The plain int8 graph
(`ops/quantize.py`) takes the reciprocal at every requant, as the JAX XLA graph does, so
under `recip` a kernel path is not bit-exact against the plain graph, in the JAX package
as here. The stride blocks and `conv3x3_int8`, having no TPU kernel, compute the XLA
graph: under `recip` they take the reciprocal at every requant.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F

from embodied_clip_tpu_torch.ops.int8 import (
    avg_pool_int8,
    full_f32,
    qconv_acc,
    qmm,
    requant,
    requant_signed,
)
from embodied_clip_tpu_torch.ops.kernels._build import Library, stream
from embodied_clip_tpu_torch.utils import profiling

__all__ = ["fused_stage1_int8", "fused_cb3_cb1_int8", "fused_resblocks_int8",
           "fused_stage1_int8_reference", "fused_cb3_cb1_int8_reference",
           "fused_resblocks_int8_reference", "fused_stride_block_int8",
           "fused_stride_block_int8_reference", "conv3x3_int8", "conv3x3_int8_reference",
           "fused_bottleneck", "fused_stage1", "fused_bottleneck_reference",
           "fused_stage1_reference", "fused_stride_block_bf16",
           "fused_stride_block_bf16_reference", "avg_pool2_bf16_reference",
           "pooled_cb3_reference"]

_OUT_KIND = {torch.int8: 1, torch.bfloat16: 2, torch.float32: 3}  # residual epilogues


# ------------------------------------------------------------------ plain versions


def _affine(acc: torch.Tensor, s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return acc.float() * s + b


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def _pw(x8: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """1×1 s8 conv as a row product: NHWC s8 × (Cin, Cout) s8 → NHWC s32."""
    return qmm(_rows(x8), k).reshape(*x8.shape[:-1], k.shape[-1])


def _shortcut_reference(x8, wsc, bsc, s_in, dsc, recip=False):
    """K3's conv shortcut, and the one launch (e) computes: bf16(x8·s_in) · wsc + bsc →
    signed s8, the f32 sum being the exact sum of the (exact) bf16 products rounded once
    to f32: computed in f64, so that it names one value on every device and in every
    summation order. `recip` takes the requant in the reciprocal form."""
    x0 = (x8.float() * s_in).to(torch.bfloat16)
    sc = torch.matmul(x0.double(), wsc.double()).float()
    return requant_signed(sc + bsc, dsc, recip)


def _stride_shortcut_reference(xp, wsc, bsc, s_in, dsc, recip=False):
    """The plain graph's conv shortcut of a stride block on its pooled input xp: bf16(xp ·
    s_in) · wsc as an f32 product (full f32), + bsc → signed s8. On a near-tie its f32 sum
    order may move the requant by a step from `_shortcut_reference`'s exact sum, which
    the kernel computes."""
    x0 = (xp.float() * s_in).to(torch.bfloat16)
    with full_f32():
        sc = torch.matmul(x0.float(), wsc.float())
    return requant_signed(sc + bsc, dsc, recip)


def _f32_up(t: torch.Tensor) -> torch.Tensor:
    """An f64 tensor rounded up to f32 (the f32 value nearest above or equal)."""
    f = t.float()
    up = torch.nextafter(f, torch.full_like(f, float("inf")))
    return torch.where(f.double() < t, up, f)


def pool2_scale_reference(x8, s_in):
    """Plain version of (f'): x0 = bf16(float(pool2(x8)) · s_in) with the exact 2×2
    integer pool, as the JAX graph feeds the stride shortcut (`quantize.py:572-574`), as
    (…, H/2, W/2, C) bf16, and each row's ||x0||₂ rounded up to f32 (…, H/2, W/2). The
    squares' f64 sum is exact (they span fewer than 53 bits), so the norm is the correctly
    rounded f64 root of the exact sum, rounded up: one value on every device."""
    x0 = (avg_pool_int8(x8, 2).float() * s_in).to(torch.bfloat16)
    return x0, _f32_up(x0.double().square().sum(-1).sqrt())


# k summed on the tensor cores before each IEEE add of the stride shortcut (e).
SHORTCUT_GROUP_K = 32


def shortcut_margins(wsc: torch.Tensor, dsc: torch.Tensor) -> torch.Tensor:
    """The stride shortcut's per-column tie-margin factors (N,) f32: (4L + G) · 2^-24 ·
    ||wsc[:, c]||₂ / dsc for L = SHORTCUT_GROUP_K and G = ceil(K / L) groups (the bound on
    |tensor-core sum − exact sum| per unit of S = Σ|x0·w| ≤ ||x0||₂ · ||wsc[:, c]||₂ in the
    argument at `kTieMargin` in csrc/bottleneck_int8.cu), widened by 2^-20 (the reciprocal
    form's quotient and f64's roundings here) and rounded up. Depends only on the weights
    and the scale: built once with the operands."""
    k = wsc.shape[0]
    groups = -(-k // SHORTCUT_GROUP_K)
    margin = (4 * SHORTCUT_GROUP_K + groups) * 2.0 ** -24
    norm = wsc.double().square().sum(0).sqrt()
    return _f32_up(margin * norm / dsc.double() * (1 + 2.0 ** -20))


def fused_cb3_cb1_int8_reference(x8, res8, ops, recip=False):
    """Plain version of K4: (out8 on r_out, y8 on r_next); `recip` takes both requants."""
    scl = ops["scl"]
    out = _affine(_pw(x8, ops["k3"]), ops["s3"], ops["b3"]) + res8.float() * scl[0]
    out8 = requant(out, scl[1], recip)
    y8 = requant(_affine(_pw(out8, ops["k1"]), ops["s1"], ops["b1"]), scl[2], recip)
    return out8, y8


def fused_resblocks_int8_reference(x8, block_ops, scl, out_dtype=torch.int8, recip=False):
    """Plain version of K5: k identity bottlenecks on scl = [r_in, (r2, r3, r_out)×k];
    `recip` takes the s8 output's requant only."""
    xq = x8
    for i, blk in enumerate(block_ops):
        r_in = scl[0] if i == 0 else scl[3 * i]
        q1 = requant(_affine(_pw(xq, blk["k1"]), blk["s1"], blk["b1"]), scl[3 * i + 1])
        q2 = requant(_affine(qconv_acc(q1, blk["k2"]), blk["s2"], blk["b2"]), scl[3 * i + 2])
        y3 = _affine(_pw(q2, blk["k3"]), blk["s3"], blk["b3"])
        out = torch.relu(y3 + xq.float() * r_in)
        if i < len(block_ops) - 1:
            xq = requant(out, scl[3 * i + 3])
    if out_dtype == torch.int8:
        return requant(out, scl[3 * len(block_ops)], recip)
    return out.to(out_dtype)


def fused_stride_block_int8_reference(x8, ops, recip=False, out_dtype=torch.int8, cb3=True,
                                      q1=None):
    """Plain version of `fused_stride_block_int8`: the plain int8 graph's stride block
    (`quantize.py:545-609`'s op order) on scl = [s_in, r2, r3, r_res, r_out]; `recip`
    takes all four requants (cb1, cb2, the shortcut, cb3) in the reciprocal form."""
    scl = ops["scl"]
    if q1 is None:
        q1 = requant(_affine(_pw(x8, ops["k1"]), ops["s1"], ops["b1"]), scl[1], recip)
    o = _affine(qconv_acc(q1, ops["k2"]), ops["s2"], ops["b2"])
    o8 = avg_pool_int8(requant(o, scl[2], recip), 2)  # requant pre-pool, as cb2's epilogue
    id8 = _stride_shortcut_reference(avg_pool_int8(x8, 2), ops["wsc"], ops["bsc"], scl[0],
                                     scl[3], recip)
    if not cb3:
        return o8, id8
    return _stride_cb3_reference(o8, id8, ops, recip, out_dtype)


def _stride_cb3_reference(o8, id8, ops, recip=False, out_dtype=torch.int8):
    """The stride block's cb3 on its pooled o8 and shortcut id8: o8·k3·s3 + b3 +
    id8·r_res, requant on r_out (`recip`: the reciprocal form), or for `out_dtype`
    bf16/f32 the relu'd conv map."""
    scl = ops["scl"]
    out = _affine(_pw(o8, ops["k3"]), ops["s3"], ops["b3"]) + id8.float() * scl[3]
    if out_dtype == torch.int8:
        return requant(out, scl[4], recip)  # the block relu is the clip at 0
    return torch.relu(out).to(out_dtype)


def conv3x3_int8_reference(x8, ops, recip=False, pool=False):
    """Plain version of `conv3x3_int8`: requant(conv3x3(x8, k)·s + b, r), then the 2×2
    pool with `pool`."""
    out = requant(_affine(qconv_acc(x8, ops["k"]), ops["s"], ops["b"]), ops["r"], recip)
    return avg_pool_int8(out, 2) if pool else out


def fused_stage1_int8_reference(x8, ops, recip=False):
    """Plain version of K3: int8 stage 1, output on stage 2's input scale; `recip` takes
    the three block outputs' requants."""
    scl = ops["scl"]  # [s_in, r2a, r3a, r_outa, r2b, r3b, r_outb, r2c, r3c, r_outc, dsc]
    x = x8
    for b, L in enumerate("abc"):
        r2, r3, r_out = scl[3 * b + 1], scl[3 * b + 2], scl[3 * b + 3]
        q1 = requant(_affine(_pw(x, ops[f"k1{L}"]), ops[f"s1{L}"], ops[f"b1{L}"]), r2)
        q2 = requant(_affine(qconv_acc(q1, ops[f"k2{L}"]), ops[f"s2{L}"], ops[f"b2{L}"]), r3)
        y = _affine(_pw(q2, ops[f"k3{L}"]), ops[f"s3{L}"], ops[f"b3{L}"])
        if b == 0:
            res8 = _shortcut_reference(x, ops["wsc"], ops["bsc"], scl[0], scl[10])
            r_res = scl[10]
        else:
            res8, r_res = x, scl[3 * b]
        x = requant(y + res8.float() * r_res, r_out, recip)
    return x


# ---------------------------------------------------------------------- the library


_p, _i = ctypes.c_void_p, ctypes.c_int
LIB_INT8 = Library("bottleneck_int8", {
    "ect_conv1x1_s8": [_p, _i, _i, _p, _i, _p, _p, _p, _p, _p, _p, _i, _i, _i, _p],
    "ect_conv3x3_s8": [_p, _i, _i, _i, _i, _p, _i, _p, _p, _p, _p, _i, _i, _p],
    "ect_shortcut_s8": [_p, _p, _i, _i, _p, _p, _i, _p, _p, _p, _p, _p, _i, _i, _p],
    "ect_pool2_scale_s8": [_p, _i, _i, _i, _i, _p, _p, _p, _i, _p],
    "ect_avg_pool2_s8": [_p, _i, _i, _i, _i, _p, _i, _p],
    "ect_cb3_cb1_s8": [_p, _p, _i, _i, _i, _i] + [_p] * 11 + [_i, _i, _p],
    "ect_stage1_entry": [_p, _i, _i, _p, _i, _p, _p, _p, _p, _i, _p, _p, _p, _p, _p, _p, _i,
                         _p],
}, sizes={"ect_stage1_entry_ties": [_i, _i], "ect_shortcut_ties": [_i, _i]})


def _ptr(t: torch.Tensor, i: int = 0) -> int:
    """Device address of element i of a contiguous f32 vector (a scale of scl)."""
    return t.data_ptr() + 4 * i


def _check_s8(name: str, t: torch.Tensor, device) -> None:
    if t.dtype != torch.int8 or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous int8 tensor on {device}, got "
                         f"{t.dtype} on {t.device}")
    if t.shape[-1] % 16 or t.data_ptr() % 16:
        raise ValueError(f"{name}: the last dim must be a multiple of 16 and the data "
                         f"16-byte aligned, got {tuple(t.shape)}")


def _check_f32(name: str, t: torch.Tensor, device, n: int) -> None:
    if (t.dtype != torch.float32 or t.device != device or not t.is_contiguous()
            or t.numel() != n or t.data_ptr() % 8):
        raise ValueError(f"{name}: expected {n} contiguous, 8-byte aligned float32 values "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _kmajor_copy(ops: Mapping[str, torch.Tensor], key: str) -> torch.Tensor:
    """The K-major (N, K) copy of s8 kernel `key` that the tensor cores read (s8 wgmma
    takes both operands K-major), built once by the operand builders of
    `ops/quantize.py`; never made here, per call."""
    t = ops.get(key + "_t")
    k = ops[key]
    if t is None or tuple(t.shape) != (k.shape[-1], k.numel() // k.shape[-1]):
        raise ValueError(f"ops have no K-major copy {key}_t of {key} {tuple(k.shape)}: build "
                         "them with the operand builders of ops/quantize.py")
    return t


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


def _check_width(name: str, n: int) -> None:
    if n % 16:
        raise ValueError(f"{name}: output channels must be a multiple of 16, got {n}")


def _conv1x1(x8, kt, s, b, r_out_ptr, out, res=None, r_res_ptr=None, recip=False):
    """(a): out = epilogue(x8 · k) for the K-major kt = k.T (Cout, Cin); s8 requant, or
    the residual epilogues. `recip` (only with an s8 output) takes the requant in the
    reciprocal form."""
    dev = x8.device
    cout, cin = kt.shape
    if (x8.shape[-1] != cin or out.shape != (*x8.shape[:-1], cout)
            or (res is not None and res.shape != out.shape)):
        raise ValueError(f"1x1: shapes x8 {tuple(x8.shape)}, kt {tuple(kt.shape)}, out "
                         f"{tuple(out.shape)} do not chain")
    _check_s8("1x1 kernel", kt, dev)
    _check_width("1x1", cout)
    _check_f32("1x1 scale", s, dev, cout)
    _check_f32("1x1 bias", b, dev, cout)
    if res is None:
        kind = 0
    else:
        _check_s8("residual", res, dev)
        kind = _OUT_KIND[out.dtype]
    LIB_INT8.ect_conv1x1_s8(x8.data_ptr(), x8.numel() // cin, cin, kt.data_ptr(), cout,
                            s.data_ptr(), b.data_ptr(), 0 if res is None else res.data_ptr(),
                            r_res_ptr or 0, r_out_ptr, out.data_ptr(), kind, int(recip),
                            *stream(x8))


def _conv3x3(x8, k2t, s, b, r_out_ptr, out, recip=False):
    """(b): out = requant(conv3x3(x8, k2)·s + b) for the K-major copy k2t (Cout, 9·C) of
    an HWIO (3, 3, C, Cout) kernel; `recip` takes the requant in the reciprocal form."""
    dev = x8.device
    n, h, w, c = x8.shape
    cout = k2t.shape[0]
    if k2t.shape[-1] != 9 * c or out.shape != (n, h, w, cout):
        raise ValueError(f"3x3 kernel: expected (Cout, {9 * c}), got {tuple(k2t.shape)}")
    _check_s8("3x3 kernel", k2t, dev)
    _check_width("3x3", cout)
    _check_f32("3x3 scale", s, dev, cout)
    _check_f32("3x3 bias", b, dev, cout)
    LIB_INT8.ect_conv3x3_s8(x8.data_ptr(), n, h, w, c, k2t.data_ptr(), cout, s.data_ptr(),
                            b.data_ptr(), r_out_ptr, out.data_ptr(), int(recip), *stream(x8))


def _avg_pool2(x8):
    """(f): the exact 2×2 integer mean pool of NHWC s8 x8 (H, W even, C a multiple of 16)."""
    n, h, w, c = x8.shape
    if h % 2 or w % 2:
        raise ValueError(f"2x2 pool: H and W must be even, got {tuple(x8.shape)}")
    _check_s8("2x2 pool input", x8, x8.device)
    out = torch.empty((n, h // 2, w // 2, c), dtype=torch.int8, device=x8.device)
    LIB_INT8.ect_avg_pool2_s8(x8.data_ptr(), n, h, w, c, out.data_ptr(), *stream(x8))
    return out


def _pool2_scale(x8, s_in_ptr):
    """(f'): the shortcut's A operand from the NHWC s8 block input x8 (H, W even, C a
    multiple of 16): (x0 (n, H/2, W/2, C) bf16, its rows' norms (n, H/2, W/2) f32), equal
    to `pool2_scale_reference` on every element."""
    n, h, w, c = x8.shape
    if h % 2 or w % 2:
        raise ValueError(f"2x2 pool + scale: H and W must be even, got {tuple(x8.shape)}")
    _check_s8("pool + scale input", x8, x8.device)
    x0 = torch.empty((n, h // 2, w // 2, c), dtype=torch.bfloat16, device=x8.device)
    rnorm = torch.empty((n, h // 2, w // 2), dtype=torch.float32, device=x8.device)
    LIB_INT8.ect_pool2_scale_s8(x8.data_ptr(), n, h, w, c, s_in_ptr, x0.data_ptr(),
                                rnorm.data_ptr(), *stream(x8))
    return x0, rnorm


def _shortcut_margins(ops: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The columns' tie-margin factors `wsc_m` (`shortcut_margins`), built once by the
    operand builder of `ops/quantize.py`; never made here, per call."""
    t = ops.get("wsc_m")
    if t is None or tuple(t.shape) != (ops["wsc"].shape[-1],):
        raise ValueError("ops have no tie margins wsc_m of the shortcut: build them with "
                         "the operand builders of ops/quantize.py")
    return t


def _shortcut(x0, rnorm, ops, dsc_ptr, recip=False):
    """(e): the stride blocks' conv shortcut on (f')'s x0 (…, Cin) bf16 and row norms
    rnorm (…): sc8 (…, Cout) on dsc, equal to `_shortcut_reference` of the pooled s8 input
    on every element; returns (sc8, the near-tie flag words: one set bit per element summed
    again exactly). ops["wsc_m"] must be `shortcut_margins` of wsc and the scale at
    dsc_ptr."""
    dev = x0.device
    wsc, wsct, bsc = ops["wsc"], ops["wsc_t"], ops["bsc"]
    cin, cout = wsc.shape
    if x0.shape[-1] != cin or rnorm.shape != x0.shape[:-1] or cin % 16 or cout % 16:
        raise ValueError(f"shortcut: x0 {tuple(x0.shape)}, rnorm {tuple(rnorm.shape)} and "
                         f"wsc {tuple(wsc.shape)} must chain, with widths that are "
                         "multiples of 16")
    m = x0.numel() // cin
    _check_bf16("x0", x0, dev, x0.shape)
    _check_f32("rnorm", rnorm, dev, m)
    _check_bf16("wsc", wsc, dev, (cin, cout))
    _check_bf16("wsc_t", wsct, dev, (cout, cin))
    _check_f32("bsc", bsc, dev, cout)
    colm = _shortcut_margins(ops)
    _check_f32("wsc_m", colm, dev, cout)
    sc8 = torch.empty((*x0.shape[:-1], cout), dtype=torch.int8, device=dev)
    words = LIB_INT8.ect_shortcut_ties(m, cout)
    # While a profiler session records, the flag words are held for a count
    # (`fused_stride_block_int8`): they come from the recorder's arena.
    ties = profiling.buffer(words, torch.int64, dev)
    if ties is None:
        ties = torch.empty(words, dtype=torch.int64, device=dev)
    LIB_INT8.ect_shortcut_s8(x0.data_ptr(), rnorm.data_ptr(), m, cin, wsc.data_ptr(),
                             wsct.data_ptr(), cout, colm.data_ptr(), bsc.data_ptr(), dsc_ptr,
                             sc8.data_ptr(), ties.data_ptr(), int(recip), *stream(x0))
    return sc8, ties


def _popcount(words: torch.Tensor) -> int:
    """Set bits of an int64 tensor, by a byte table."""
    table = torch.tensor([bin(b).count("1") for b in range(256)], dtype=torch.int32,
                         device=words.device)
    return int(table[words.contiguous().view(torch.uint8).long()].sum())


def _tail_near_ties(words: torch.Tensor, row0: int, col0: int, m: int, n: int) -> int:
    """Set bits of (e)'s flag words (row tiles, column tiles, 256) whose first tile sits
    at output (row0, col0), counting only the bits of elements inside (m, n): word
    `tid` of a tile holds rows r, r + 8 (r = 64·(tid / 128) + 16·(tid % 128 / 32) +
    (tid % 32) / 4) and columns c + 8j, c + 8j + 1 (c = 2·(tid % 4), j < 16); bit 4j +
    2h + e is (r + 8h, c + 8j + e), as `csrc/bottleneck_int8.cu`'s flush decodes it."""
    rt, ct, _ = words.shape
    dev = words.device
    tid = torch.arange(256, device=dev)
    lane = tid % 32
    rows = (row0 + 128 * torch.arange(rt, device=dev)[:, None, None] + 64 * (tid // 128)
            + 16 * (tid % 128 // 32) + lane // 4)                               # (rt, 1, 256)
    cols = col0 + 128 * torch.arange(ct, device=dev)[None, :, None] + 2 * (lane % 4)
    h = torch.arange(2, device=dev)
    j = torch.arange(16, device=dev)
    e = torch.arange(2, device=dev)
    row_ok = (rows[..., None] + 8 * h) < m                                      # (rt, 1, 256, 2)
    col_ok = (cols[..., None, None] + 8 * j[:, None] + e) < n                   # (1, ct, 256, 16, 2)
    ok = (col_ok[..., :, None, :] & row_ok[..., None, :, None]).reshape(rt, ct, 256, 64)
    bits = (words[..., None] >> torch.arange(64, device=dev)) & 1
    return int((bits.bool() & ok).sum())


def shortcut_near_ties(ties: torch.Tensor, m: int, n: int) -> int:
    """The elements of an (m, n) shortcut output that (e) flagged as near-ties and summed
    again exactly: the set bits of its flag words `ties` (`ect_shortcut_ties(m, n)`
    int64 words, 256 a 128×128 tile, every word written by the launch), the bits of rows
    at or past m, and of columns at or past n, left out."""
    n_tiles = -(-n // 128)
    words = ties.view(-1, n_tiles, 256)
    full_r, full_c = m // 128, n // 128
    total = _popcount(words[:full_r, :full_c])
    if full_c < n_tiles:
        total += _tail_near_ties(words[:full_r, full_c:], 0, 128 * full_c, m, n)
    if full_r < words.shape[0]:
        total += _tail_near_ties(words[full_r:], 128 * full_r, 0, m, n)
    return total


ENTRY_WIDTHS = {16: 64, 64: 256, 96: 384}  # K3's entry: Cin (= Cm) → Cout


def _stage1_entry(x8, ops, r1_ptr, s_in_ptr, dsc_ptr):
    """(d): one launch for cb1a and the conv shortcut of stage 1's block 0; returns (q1
    (…, Cm) on r1, sc8 (…, Cout) on dsc, the launch's near-tie flag words: one set bit
    per shortcut element that it summed again exactly)."""
    dev = x8.device
    cin = x8.shape[-1]
    k1t, wsc, bsc = _kmajor_copy(ops, "k1a"), ops["wsc"], ops["bsc"]
    cm, cout = k1t.shape[0], wsc.shape[-1]
    if ENTRY_WIDTHS.get(cin) != cout or cm != cin:
        raise ValueError(f"fused_stage1_int8 takes (Cin = Cm, Cout) in "
                         f"{sorted(ENTRY_WIDTHS.items())}, got Cin = {cin}, Cm = {cm}, "
                         f"Cout = {cout}")
    _check_bf16("wsc", wsc, dev, (cin, cout))
    _check_s8("cb1a kernel", k1t, dev)
    for nm, t, n in (("cb1a scale", ops["s1a"], cm), ("cb1a bias", ops["b1a"], cm),
                     ("bsc", bsc, cout)):
        _check_f32(nm, t, dev, n)
    m = x8.numel() // cin
    q1 = torch.empty((*x8.shape[:-1], cm), dtype=torch.int8, device=dev)
    sc8 = torch.empty((*x8.shape[:-1], cout), dtype=torch.int8, device=dev)
    # The shortcut's near-tie flag words (1/8 of sc8's bytes).
    ties = torch.empty(LIB_INT8.ect_stage1_entry_ties(m, cout), dtype=torch.int64, device=dev)
    LIB_INT8.ect_stage1_entry(x8.data_ptr(), m, cin, k1t.data_ptr(), cm, ops["s1a"].data_ptr(),
                              ops["b1a"].data_ptr(), r1_ptr, wsc.data_ptr(), cout, s_in_ptr,
                              bsc.data_ptr(), dsc_ptr, q1.data_ptr(), sc8.data_ptr(),
                              ties.data_ptr(), *stream(x8))
    return q1, sc8, ties


def _cb3_cb1(x8, res8, k3t, s3, b3, k1t, s1, b1, r_res_ptr, r_out_ptr, r_next_ptr,
             recip_out=False, recip_next=False):
    """(c): one launch for the K-major k3t (C, Cm) and k1t (C1, C); returns (out8 (…, C),
    y8 (…, C1)). `recip_out` and `recip_next` take out8's and y8's requants in the
    reciprocal form (K4 both, K3 out8's only, K5 neither)."""
    dev = x8.device
    c, cm = k3t.shape
    c1 = k1t.shape[0]
    if (x8.shape[-1] != cm or res8.shape[:-1] != x8.shape[:-1] or res8.shape[-1] != c
            or k1t.shape[-1] != c):
        raise ValueError(f"cb3·cb1: shapes x8 {tuple(x8.shape)}, res8 {tuple(res8.shape)}, "
                         f"k3t {tuple(k3t.shape)}, k1t {tuple(k1t.shape)} do not chain")
    for nm, t in (("residual", res8), ("cb3 kernel", k3t), ("cb1 kernel", k1t)):
        _check_s8(nm, t, dev)
    _check_width("cb1", c1)
    for nm, t, n in (("cb3 scale", s3, c), ("cb3 bias", b3, c), ("cb1 scale", s1, c1),
                     ("cb1 bias", b1, c1)):
        _check_f32(nm, t, dev, n)
    out8 = torch.empty((*x8.shape[:-1], c), dtype=torch.int8, device=dev)
    y8 = torch.empty((*x8.shape[:-1], c1), dtype=torch.int8, device=dev)
    # The kernel refuses a C whose resident block-output tile leaves no room for a ring.
    LIB_INT8.ect_cb3_cb1_s8(x8.data_ptr(), res8.data_ptr(), x8.numel() // cm, cm, c, c1,
                            k3t.data_ptr(), s3.data_ptr(), b3.data_ptr(), k1t.data_ptr(),
                            s1.data_ptr(), b1.data_ptr(), r_res_ptr, r_out_ptr, r_next_ptr,
                            out8.data_ptr(), y8.data_ptr(),
                            int(recip_out) | 2 * int(recip_next), *stream(x8))
    return out8, y8


# ------------------------------------------------------------------------ wrappers


def fused_cb3_cb1_int8(x8: torch.Tensor, res8: torch.Tensor, ops: Dict[str, torch.Tensor],
                       recip: bool = False):
    """Block n's cb3 + residual + requant fused with block n+1's cb1 + requant.

    x8 (N, H, W, Cm) s8: block n's cb2 output; res8 (N, H, W, C) s8 on scl[0]; ops
    from `ops/quantize.cb3_cb1_operands`: k3 (Cm, C), s3/b3 (C,), k1 (C, C1), s1/b1
    (C1,), the K-major copies k3_t, k1_t, scl = [r_res, r_out, r_next]. Returns (out8
    (N, H, W, C) on r_out, y8 (N, H, W, C1) on r_next). Bit-exact against the plain
    version, in either requant form (`recip`, both requants)."""
    if _cuda_input("fused_cb3_cb1_int8", x8):
        return fused_cb3_cb1_int8_reference(x8, res8, ops, recip)
    scl = ops["scl"]
    _check_f32("scl", scl, x8.device, 3)
    out = _cb3_cb1(x8, res8, _kmajor_copy(ops, "k3"), ops["s3"], ops["b3"], _kmajor_copy(ops, "k1"),
                   ops["s1"], ops["b1"], _ptr(scl, 0), _ptr(scl, 1), _ptr(scl, 2),
                   recip_out=recip, recip_next=recip)
    fused_cb3_cb1_int8.launches += 1
    return out


def fused_resblocks_int8(x8: torch.Tensor, block_ops: Sequence[Dict[str, torch.Tensor]],
                         scl: torch.Tensor, out_dtype=torch.int8,
                         recip: bool = False) -> torch.Tensor:
    """k consecutive stride-1 identity int8 bottlenecks.

    x8 (N, H, W, C) s8 on scl[0]; block_ops from `ops/quantize.resblocks_int8_operands`:
    per block k1 (C, Cm), s1, b1, k2 (3, 3, Cm, Cm), s2, b2, k3 (Cm, C), s3, b3 and the
    K-major copies k1_t, k2_t, k3_t; scl
    (3k+1,) = [r_in, (r2, r3, r_out) × k]. Returns (N, H, W, C): s8 requantized on the
    last r_out, or, for `out_dtype` bf16/f32, the trunk's final conv map (relu'd, no
    requant). Bit-exact against the plain version, in either requant form (`recip`, the s8
    output's requant only)."""
    if _cuda_input("fused_resblocks_int8", x8):
        return fused_resblocks_int8_reference(x8, block_ops, scl, out_dtype, recip)
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"fused_resblocks_int8 writes int8, bfloat16 or float32, "
                         f"not {out_dtype}")
    nb = len(block_ops)
    _check_f32("scl", scl, x8.device, 3 * nb + 1)
    dev = x8.device
    shape, cm = x8.shape[:-1], block_ops[0]["k1"].shape[-1]
    q1 = torch.empty((*shape, cm), dtype=torch.int8, device=dev)
    first = block_ops[0]
    _conv1x1(x8, _kmajor_copy(first, "k1"), first["s1"], first["b1"], _ptr(scl, 1), q1)
    xq = x8
    for i, blk in enumerate(block_ops):
        q2 = torch.empty((*shape, blk["k2"].shape[-1]), dtype=torch.int8, device=dev)
        _conv3x3(q1, _kmajor_copy(blk, "k2"), blk["s2"], blk["b2"], _ptr(scl, 3 * i + 2), q2)
        r_res = _ptr(scl, 0 if i == 0 else 3 * i)
        if i < nb - 1:
            nxt = block_ops[i + 1]
            xq, q1 = _cb3_cb1(q2, xq, _kmajor_copy(blk, "k3"), blk["s3"], blk["b3"],
                              _kmajor_copy(nxt, "k1"), nxt["s1"], nxt["b1"], r_res,
                              _ptr(scl, 3 * i + 3), _ptr(scl, 3 * i + 4))
        else:
            out = torch.empty(x8.shape, dtype=out_dtype, device=dev)
            _conv1x1(q2, _kmajor_copy(blk, "k3"), blk["s3"], blk["b3"], _ptr(scl, 3 * nb), out,
                     res=xq, r_res_ptr=r_res, recip=recip and out_dtype == torch.int8)
    fused_resblocks_int8.launches += 1
    return out


def fused_stage1_int8(x8: torch.Tensor, ops: Dict[str, torch.Tensor],
                      recip: bool = False) -> torch.Tensor:
    """The whole int8 CLIP-RN50 stage 1: x8 (N, H, W, Cin) s8 on the stem.out scale,
    ops from `ops/quantize.stage1_int8_operands`. Returns (N, H, W, Cout) s8 already
    requantized to stage 2's input scale. Held to the plain version at ≤1 s8 step on
    ≤0.5% of elements. The bf16 shortcut's f32 sum is the one non-integer reduction: the
    tensor cores sum it in their own order, and every element whose requant that order
    could change is summed again exactly, as the plain version does. `recip` takes the
    three block outputs' requants in the reciprocal form."""
    if _cuda_input("fused_stage1_int8", x8):
        return fused_stage1_int8_reference(x8, ops, recip)
    scl = ops["scl"]
    dev = x8.device
    _check_f32("scl", scl, dev, 11)
    shape = x8.shape[:-1]
    cout = ops["wsc"].shape[-1]
    q1, sc8, _ = _stage1_entry(x8, ops, _ptr(scl, 1), _ptr(scl, 0), _ptr(scl, 10))
    cm = q1.shape[-1]

    def s8(c):
        return torch.empty((*shape, c), dtype=torch.int8, device=dev)

    res8, r_res = sc8, _ptr(scl, 10)
    for b, L in enumerate("abc"):
        q2 = s8(cm)
        _conv3x3(q1, _kmajor_copy(ops, f"k2{L}"), ops[f"s2{L}"], ops[f"b2{L}"],
                 _ptr(scl, 3 * b + 2), q2)
        if L != "c":
            nx = "abc"[b + 1]
            res8, q1 = _cb3_cb1(q2, res8, _kmajor_copy(ops, f"k3{L}"), ops[f"s3{L}"],
                                ops[f"b3{L}"], _kmajor_copy(ops, f"k1{nx}"), ops[f"s1{nx}"],
                                ops[f"b1{nx}"], r_res, _ptr(scl, 3 * b + 3),
                                _ptr(scl, 3 * b + 4), recip_out=recip)
            r_res = _ptr(scl, 3 * b + 3)
        else:
            out = s8(cout)
            _conv1x1(q2, _kmajor_copy(ops, "k3c"), ops["s3c"], ops["b3c"], _ptr(scl, 9), out,
                     res=res8, r_res_ptr=r_res, recip=recip)
    fused_stage1_int8.launches += 1
    return out


def fused_stride_block_int8(x8: torch.Tensor, ops: Dict[str, torch.Tensor], recip: bool = False,
                            out_dtype=torch.int8, cb3: bool = True, q1=None):
    """Block 0 of a later stage of the int8 CLIP trunk (stride 2 through the pools).

    x8 (N, H, W, Cin) s8 on scl[0], H and W even; ops from
    `ops/quantize.stride_block_int8_operands`: k1 (Cin, Cm), s1, b1, k2 (3, 3, Cm, Cm), s2,
    b2, k3 (Cm, C), s3, b3, the K-major copies k1_t, k2_t, k3_t, the bf16 shortcut wsc
    (Cin, C) with its K-major copy wsc_t, its tie margins wsc_m and bias bsc, scl = [s_in,
    r2, r3, r_res, r_out].
    In the JAX graph's op order: cb1 + requant on r2; the 3×3 cb2 at the input resolution
    + requant on r3; the exact 2×2 integer pool of that and of x8; the conv shortcut of
    the pooled x8 (bf16 operands, f32 sum) + signed requant on r_res; cb3 + bias +
    id8·r_res + requant on r_out. Returns (N, H/2, W/2, C) s8, or for `out_dtype` bf16/f32
    the trunk's final conv map (relu'd, no requant). With `cb3` False (path B, where K4
    takes cb3 with the next block's cb1) returns (o8 (N, H/2, W/2, Cm), id8 (N, H/2, W/2,
    C)); `q1`, cb1's output on r2 where K4 made it, leaves cb1 out.

    cb1, cb2, the pools and cb3 are bit-exact against the plain version (cb3 on the
    kernel's own o8 and id8: `parity.stride_block_disagreement`); the shortcut equals the
    exact sum's requant on every element (its near-ties summed again exactly), from which
    the plain graph's full-f32 product may differ by one step on a near-tie, so id8 and
    the output are held at ≤1 s8 step on ≤0.5% of elements, K3's contract. `recip` takes all four requants in the reciprocal form, as the XLA graph
    does. While a profiler session records, the counters `sb.shortcut_elements` and
    `sb.near_tie_elements` (the shortcut's flagged near-ties, `shortcut_near_ties`,
    counted from the held flag words when the session is read) grow by each call's."""
    if _cuda_input("fused_stride_block_int8", x8):
        return fused_stride_block_int8_reference(x8, ops, recip, out_dtype, cb3, q1)
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"fused_stride_block_int8 writes int8, bfloat16 or float32, "
                         f"not {out_dtype}")
    dev = x8.device
    n, h, w, cin = x8.shape
    if h % 2 or w % 2:
        raise ValueError(f"fused_stride_block_int8: H and W must be even, got {tuple(x8.shape)}")
    scl = ops["scl"]
    _check_f32("scl", scl, dev, 5)
    k2t = _kmajor_copy(ops, "k2")
    cm = k2t.shape[0]
    if q1 is None:
        q1 = torch.empty((n, h, w, cm), dtype=torch.int8, device=dev)
        _conv1x1(x8, _kmajor_copy(ops, "k1"), ops["s1"], ops["b1"], _ptr(scl, 1), q1,
                 recip=recip)
    elif q1.shape != (n, h, w, cm):
        raise ValueError(f"q1 {tuple(q1.shape)} is not cb1's output of {tuple(x8.shape)}")
    else:
        _check_s8("q1", q1, dev)
    q2 = torch.empty((n, h, w, cm), dtype=torch.int8, device=dev)
    _conv3x3(q1, k2t, ops["s2"], ops["b2"], _ptr(scl, 2), q2, recip=recip)
    o8 = _avg_pool2(q2)
    x0, rnorm = _pool2_scale(x8, _ptr(scl, 0))
    id8, ties = _shortcut(x0, rnorm, ops, _ptr(scl, 3), recip)
    m, cout = x0.numel() // cin, id8.shape[-1]
    if profiling.hold("sb.near_tie_elements", shortcut_near_ties, ties, m, cout):
        profiling.count("sb.shortcut_elements", m * cout)
    if cb3:
        out = torch.empty(id8.shape, dtype=out_dtype, device=dev)
        _conv1x1(o8, _kmajor_copy(ops, "k3"), ops["s3"], ops["b3"], _ptr(scl, 4), out,
                 res=id8, r_res_ptr=_ptr(scl, 3), recip=recip and out_dtype == torch.int8)
    fused_stride_block_int8.launches += 1
    return out if cb3 else (o8, id8)


def conv3x3_int8(x8: torch.Tensor, ops: Dict[str, torch.Tensor], recip: bool = False,
                 pool: bool = False) -> torch.Tensor:
    """An s8 3×3 'SAME' conv at stride 1 with its requant epilogue: requant(conv3x3(x8,
    k)·s + b, r), and with `pool` the exact 2×2 integer pool of that (H, W even): the
    int8-stem options' stem2 and stem3 (`quantize.py:446-473`). ops from
    `ops/quantize.conv3x3_int8_operands`: k (3, 3, C, Cout), its K-major copy k_t, s, b
    (Cout,), r (1,). Bit-exact against the plain version; `recip` takes the requant in
    the reciprocal form."""
    if _cuda_input("conv3x3_int8", x8):
        return conv3x3_int8_reference(x8, ops, recip, pool)
    _check_f32("r", ops["r"], x8.device, 1)
    if pool and (x8.shape[1] % 2 or x8.shape[2] % 2):
        raise ValueError(f"conv3x3_int8: H and W must be even to pool, got {tuple(x8.shape)}")
    out = torch.empty((*x8.shape[:-1], ops["k"].shape[-1]), dtype=torch.int8, device=x8.device)
    _conv3x3(x8, _kmajor_copy(ops, "k"), ops["s"], ops["b"], ops["r"].data_ptr(), out,
             recip=recip)
    if pool:
        out = _avg_pool2(out)
    conv3x3_int8.launches += 1
    return out


fused_stage1_int8.launches = 0
fused_cb3_cb1_int8.launches = 0
fused_resblocks_int8.launches = 0
fused_stride_block_int8.launches = 0
conv3x3_int8.launches = 0


# ------------------------------------------------------- K6, K7: bf16 plain versions
#
# A block's weights are a dict {w1 (C, Cm), b1 (Cm,), w2 (3, 3, Cm, Cm) HWIO, b2 (Cm,),
# w3 (Cm, C'), b3 (C',)}, as the JAX kernels take them. The plain versions accept any
# float x; they cast the weights to x's dtype and round to it where the TPU kernels do:
# h1 and h2 once each, the block output once.


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (…, K) · w (K, N) in f32 on values in a's dtype (exact products for bf16)."""
    return torch.matmul(a.float(), w.to(a.dtype).float())


def _h2(x: torch.Tensor, blk: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """A bottleneck's (a) and (b) at x's resolution: h2 = relu(conv3x3(relu(x·w1 + b1))
    + b2), h1 and h2 each rounded once to x's dtype."""
    dt = x.dtype
    with full_f32():
        h1 = torch.relu(_mm(x, blk["w1"]) + blk["b1"].float()).to(dt)
        k2 = blk["w2"].to(dt).float().permute(3, 2, 0, 1)  # HWIO → OIHW
        acc = F.conv2d(h1.float().permute(0, 3, 1, 2), k2, padding=1).permute(0, 2, 3, 1)
        return torch.relu(acc + blk["b2"].float()).to(dt)


def _bottleneck_pre(x: torch.Tensor, blk: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """One stride-1 bottleneck before its residual: f32 h2·w3 + b3 (`_bottleneck_body`)."""
    h2 = _h2(x, blk)
    with full_f32():
        return _mm(h2, blk["w3"]) + blk["b3"].float()


def _block(w1, b1, w2, b2, w3, b3) -> Dict[str, torch.Tensor]:
    return {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3}


def fused_bottleneck_reference(x, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """Plain version of K6: relu(h2·w3 + b3 + x) in f32, cast to x's dtype."""
    pre = _bottleneck_pre(x, _block(w1, b1, w2, b2, w3, b3))
    return torch.relu(pre + x.float()).to(x.dtype)


def fused_stage1_reference(x, blocks: Sequence[Mapping[str, torch.Tensor]],
                           shortcut: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Plain version of K7: block 0 with the conv shortcut, then identity blocks."""
    ws, bs = shortcut
    with full_f32():
        sc = _mm(x, ws) + bs.float()
    out = torch.relu(_bottleneck_pre(x, blocks[0]) + sc).to(x.dtype)
    for blk in blocks[1:]:
        out = torch.relu(_bottleneck_pre(out, blk) + out.float()).to(x.dtype)
    return out


def avg_pool2_bf16_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of P on one NHWC tensor: `F.avg_pool2d(·, 2)` on its NCHW view (each
    2×2 window summed in f32, rounded once to x's dtype; odd H or W floor-sized)."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def pooled_cb3_reference(p, xp, w3, b3, wds, bds) -> torch.Tensor:
    """Plain version of the bf16 stride block's (c): relu(p·w3 + b3 + xp·wds + bds) in
    f32, cast to p's dtype."""
    with full_f32():
        out = _mm(p, w3) + b3.float() + (_mm(xp, wds) + bds.float())
    return torch.relu(out).to(p.dtype)


def fused_stride_block_bf16_reference(x, w1, b1, w2, b2, w3, b3, wds, bds) -> torch.Tensor:
    """Plain version of `fused_stride_block_bf16`: h1, h2 at x's resolution as K6 rounds
    them, p and xp the 2×2 pools of h2 and x (`avg_pool2_bf16_reference`), then
    `pooled_cb3_reference`."""
    p = avg_pool2_bf16_reference(_h2(x, _block(w1, b1, w2, b2, w3, b3)))
    return pooled_cb3_reference(p, avg_pool2_bf16_reference(x), w3, b3, wds, bds)


# ------------------------------------------------------------------ K6, K7: wrappers


LIB_BF16 = Library("bottleneck_bf16", {
    "ect_gemm_bf16": [_p, _i, _i, _p, _i, _p, _p, _i, _p, _p, _p, _p, _i, _i, _i, _i, _p],
    "ect_avg_pool2_pair_bf16": [_p, _i, _p, _i, _i, _i, _i, _p, _p, _i, _p]})


def _check_bf16(name: str, t: torch.Tensor, device, shape) -> None:
    if (t.dtype != torch.bfloat16 or t.device != device or not t.is_contiguous()
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{name}: expected a contiguous bfloat16 {tuple(shape)} tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the data must be 16-byte aligned")


def _cuda_bf16_input(kernel: str, x: torch.Tensor) -> bool:
    """True for a CPU tensor (take the plain version); raise unless the kernel takes x."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {x.device}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{kernel}: the kernel takes bfloat16, got {x.dtype}")
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError(f"{kernel}: expected a contiguous NHWC tensor, got shape "
                         f"{tuple(x.shape)}, strides {x.stride()}")
    if x.shape[-1] % 8 or x.data_ptr() % 16:
        raise ValueError(f"{kernel}: C must be a multiple of 8 and the data 16-byte "
                         f"aligned, got C = {x.shape[-1]}")
    return False


def _gemm(a, w, bias, out, conv3=False, res=None, a2=None, w2=None, bias2=None) -> None:
    """One launch: out = bf16(relu(a·w [+ a2·w2] + bias [+ bias2] [+ res])); `conv3`
    makes a·w the 3×3 'SAME' convolution of NHWC a with the HWIO kernel w."""
    dev = a.device
    c, n = a.shape[-1], out.shape[-1]
    k = 9 * c if conv3 else c
    _check_bf16("kernel", w, dev, (3, 3, c, n) if conv3 else (c, n))
    _check_f32("bias", bias, dev, n)
    if res is not None:
        _check_bf16("residual", res, dev, out.shape)
    k2 = 0
    if a2 is not None:
        k2 = a2.shape[-1]
        _check_bf16("shortcut kernel", w2, dev, (k2, n))
        _check_f32("shortcut bias", bias2, dev, n)
    if n % 8:
        raise ValueError(f"output channels must be a multiple of 8, got {n}")
    h, wd = (a.shape[1], a.shape[2]) if conv3 else (1, 1)
    LIB_BF16.ect_gemm_bf16(
        a.data_ptr(), a.numel() // c, k, w.data_ptr(), n, bias.data_ptr(),
        a2.data_ptr() if a2 is not None else 0, k2, w2.data_ptr() if a2 is not None else 0,
        bias2.data_ptr() if a2 is not None else 0, res.data_ptr() if res is not None else 0,
        out.data_ptr(), c if conv3 else 0, h, wd, *stream(a))


def _bottleneck_launches(x, blk, h1, h2, shortcut=None) -> torch.Tensor:
    """K6's three launches (with K7's shortcut on block 0's last); h1/h2 are scratch."""
    cm = blk["w1"].shape[-1]
    if blk["w2"].shape[-1] != cm or h1.shape[-1] != cm or cm % 8:
        raise ValueError(f"bottleneck width Cm = {cm} must be a multiple of 8 and chain "
                         f"through w2 {tuple(blk['w2'].shape)}")
    out = torch.empty((*x.shape[:-1], blk["w3"].shape[-1]), dtype=x.dtype, device=x.device)
    _gemm(x, blk["w1"], blk["b1"], h1)
    _gemm(h1, blk["w2"], blk["b2"], h2, conv3=True)
    if shortcut is None:
        if out.shape != x.shape:
            raise ValueError(f"identity bottleneck: w3 {tuple(blk['w3'].shape)} does not "
                             f"map back to C = {x.shape[-1]}")
        _gemm(h2, blk["w3"], blk["b3"], out, res=x)
    else:
        _gemm(h2, blk["w3"], blk["b3"], out, a2=x, w2=shortcut[0], bias2=shortcut[1])
    return out


def fused_bottleneck(x: torch.Tensor, w1, b1, w2, b2, w3, b3) -> torch.Tensor:
    """One stride-1 bottleneck with BN folded in: relu(conv1x1_3(relu(conv3x3(relu(
    conv1x1_1(x))))) + x).

    x (N, H, W, C) NHWC; w1 (C, Cm), w2 (3, 3, Cm, Cm) HWIO, w3 (Cm, C) in x's dtype;
    b1, b2 (Cm,), b3 (C,) f32. On CUDA the kernel takes contiguous bf16 x and weights,
    with C and Cm multiples of 8, and raises on anything else; it agrees with the plain
    version up to the bf16 roundings of h1/h2 that the f32 sum order flips on near-ties.

    Not ported from the TPU kernel: `batch_tile` (a VMEM grid knob) and
    `supports_fused_bottleneck` (a TPU VMEM budget); the module's `_unscale` is the int8
    kernels' `recip`."""
    if _cuda_bf16_input("fused_bottleneck", x):
        return fused_bottleneck_reference(x, w1, b1, w2, b2, w3, b3)
    shape = (*x.shape[:-1], w1.shape[-1])
    h1 = torch.empty(shape, dtype=x.dtype, device=x.device)
    out = _bottleneck_launches(x, _block(w1, b1, w2, b2, w3, b3), h1, torch.empty_like(h1))
    fused_bottleneck.launches += 1
    return out


def fused_stage1(x: torch.Tensor, blocks: Sequence[Mapping[str, torch.Tensor]],
                 shortcut: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """The whole stage 1 of a folded bottleneck trunk: block 0 maps Cin → Cout with the
    1×1 conv `shortcut` = (ws (Cin, Cout), bs (Cout,)) added before its relu; the blocks
    after it are identity bottlenecks (3 blocks in RN50; any number ≥ 1 here).

    x (N, H, W, Cin) NHWC; `blocks` as for `fused_bottleneck` (block 0's w1 is
    (Cin, Cm), its w3 (Cm, Cout)). Rounds where K6 rounds, the block outputs once each.
    The same kernel requirements as `fused_bottleneck`; `batch_tile` is not ported."""
    if _cuda_bf16_input("fused_stage1", x):
        return fused_stage1_reference(x, blocks, shortcut)
    cm = blocks[0]["w1"].shape[-1]
    if any(b["w1"].shape[-1] != cm for b in blocks):
        raise ValueError("fused_stage1: every block must have the same width Cm")
    h1 = torch.empty((*x.shape[:-1], cm), dtype=x.dtype, device=x.device)
    h2 = torch.empty_like(h1)
    out = _bottleneck_launches(x, blocks[0], h1, h2, shortcut=shortcut)
    for blk in blocks[1:]:
        out = _bottleneck_launches(out, blk, h1, h2)
    fused_stage1.launches += 1
    return out


def _avg_pool2_pair(a: torch.Tensor, b: torch.Tensor):
    """P, one launch: the 2×2 average pools (`avg_pool2_bf16_reference`, bit for bit) of
    the NHWC bf16 tensors a and b, which share N, H and W."""
    n, h, w, _ = a.shape
    if b.ndim != 4 or tuple(b.shape[:3]) != (n, h, w):
        raise ValueError(f"2x2 pools: a {tuple(a.shape)} and b {tuple(b.shape)} must share "
                         "N, H and W")
    outs = []
    for t in (a, b):
        _check_bf16("pool input", t, a.device, t.shape)
        if t.shape[-1] % 8:
            raise ValueError(f"2x2 pools: C must be a multiple of 8, got {t.shape[-1]}")
        outs.append(torch.empty((n, h // 2, w // 2, t.shape[-1]), dtype=t.dtype,
                                device=t.device))
    LIB_BF16.ect_avg_pool2_pair_bf16(a.data_ptr(), a.shape[-1], b.data_ptr(), b.shape[-1],
                                     n, h, w, outs[0].data_ptr(), outs[1].data_ptr(),
                                     *stream(a))
    return outs[0], outs[1]


def fused_stride_block_bf16(x: torch.Tensor, w1, b1, w2, b2, w3, b3, wds, bds) -> torch.Tensor:
    """CLIP's anti-aliased stride-2 bottleneck with BN folded in: relu(conv1x1_3(pool2(
    relu(conv3x3(relu(conv1x1_1(x)))))) + conv1x1_ds(pool2(x))), every conv at stride 1
    and both 2×2 average pools floor-sized.

    x (N, H, W, Cin) NHWC; w1 (Cin, Cm), w2 (3, 3, Cm, Cm) HWIO, w3 (Cm, Cout) and the
    shortcut's wds (Cin, Cout) in x's dtype; b1, b2 (Cm,), b3, bds (Cout,) f32. Four
    launches: (a) and (b) of K6 at x's resolution, P (the pools of h2 and x), and (c) with
    the pooled shortcut as K7's second K loop. The same kernel requirements as
    `fused_bottleneck` (Cin, Cm and Cout multiples of 8); it agrees with the plain version
    up to the roundings that the f32 sum order flips on near-ties."""
    if _cuda_bf16_input("fused_stride_block_bf16", x):
        return fused_stride_block_bf16_reference(x, w1, b1, w2, b2, w3, b3, wds, bds)
    n, h, w, _ = x.shape
    h1 = torch.empty((n, h, w, w1.shape[-1]), dtype=x.dtype, device=x.device)
    h2 = torch.empty_like(h1)
    _gemm(x, w1, b1, h1)
    _gemm(h1, w2, b2, h2, conv3=True)
    p, xp = _avg_pool2_pair(h2, x)
    out = torch.empty((n, h // 2, w // 2, w3.shape[-1]), dtype=x.dtype, device=x.device)
    _gemm(p, w3, b3, out, a2=xp, w2=wds, bias2=bds)
    fused_stride_block_bf16.launches += 1
    return out


fused_bottleneck.launches = 0
fused_stage1.launches = 0
fused_stride_block_bf16.launches = 0
