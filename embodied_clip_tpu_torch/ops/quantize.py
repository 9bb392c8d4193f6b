"""Post-training int8 quantization of the frozen ResNet trunks (port of
`embodied_clip_tpu/ops/quantize.py`: the CLIP trunk, and the torchvision trunk at
`:613-738`).

Scheme (symmetric PTQ, as in the JAX package):
  weights      s8 per output channel, scale = max|w| / 127
  activations  s8 per tensor, scale = max / 127, calibrated on sample frames; every
               conv input is post-ReLU, the conv shortcut's output is signed
  stem convs and the 1×1 shortcut convs stay bf16 with f32 accumulation; the CLIP
               stem convs' outputs stay f32, unrounded, as XLA leaves them.

The quantized trunk is a dict shaped like the JAX package's `qtrunk`:
  {"act_scales": {name: 0-dim f32}, "fp": {"stem1"|…|"layerS_B/down": {"kernel" HWIO
   f32, "bias"}}, "layerS_B/cbI" and "stem2"/"stem3": {"kernel_q" HWIO s8, "w_scale"
   (Cout,), "bias"}}
with every tensor on the trunk's device; `models/convert.py:from_flax_qtrunk` carries a
JAX `qtrunk` across. The s8 stem2/stem3 entries serve the int8-stem option; the fp ones
the default stem. The kernels' derived operands are built on first use and kept under
the key "_operands".

`quantized_trunk_apply` is the dispatch of `quantize.py:381-610`. Its four kernel
switches are the JAX keyword arguments under the port's names:

  kernel_stem      (pallas_stem)       K2 stem3_requant_pool_int8
  kernel_stage1    (pallas_stage1)     K3 fused_stage1_int8
  kernel_resblocks (pallas_resblocks)  K5 fused_resblocks_int8 on identity runs
  fuse_pointwise   (fuse_pointwise)    K4 fused_cb3_cb1_int8 at block boundaries

With all of them off it is the plain graph. `PATH_A` (K2 + K3 + K5) is what a
quantized encoder runs; `PATH_B` swaps K5 for K4. What the kernels do not cover (the
stem1/stem2 convs, and each later stage's stride block 0) runs as plain torch:
cuDNN for the convs of bf16 operands, `torch._int_mm` (+ im2col) for the s8 ones.
Three options change what the graph computes, each the JAX package's trace-time
environment variable as a keyword, defaulting as JAX does:

  recip_requant  (ECT_RECIP_REQUANT=1)  every requant of the graph as a multiply by the
                                        scale's reciprocal; K2-K5 take that form where
                                        the TPU kernels do (ops/kernels/bottleneck_kernel.py)
  int8_stem      (ECT_INT8_STEM)        "stem3": stem3 an s8 conv; "full": stem2 and
                                        stem3 s8, stem1's output requantized; K2 is
                                        not called under either
  int4_stage1    (ECT_INT4_STAGE1)      stage 1's activations on a 4-bit grid (1: all;
                                        2: the block outputs and the shortcut), plain
                                        graph only, values held in s8 tensors

The torchvision trunk (`calibrate_resnet_trunk`, `quantize_resnet_trunk`,
`quantized_resnet_apply`) has the same scheme and tree, with the 7×7/2 stem ("stem")
requantized before an exact int8 max pool, stride-2 3×3 s8 convs (a strided im2col),
and bf16 `down` convs whose output makes the signed s8 round trip. Like the JAX
package's, it runs no kernel; it takes `recip_requant`.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from embodied_clip_tpu_torch.ops.int8 import (
    QMAX,
    avg_pool_int8,
    full_f32,
    max_pool_int8,
    qconv_acc,
    requant,
    requant_s4,
    requant_signed,
    requant_u4,
)
from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
from embodied_clip_tpu_torch.ops.kernels import stem_kernel as SK

__all__ = ["calibrate_trunk", "quantize_trunk", "quantized_trunk_apply",
           "calibrate_resnet_trunk", "quantize_resnet_trunk", "quantized_resnet_apply",
           "stage1_int8_operands", "cb3_cb1_operands", "resblocks_int8_operands",
           "PATH_A", "PATH_B", "KERNELS_OFF", "INT8_STEMS", "PALLAS_RESBLOCKS_MIN_CM"]

KERNELS_OFF = dict(kernel_stem=False, kernel_stage1=False, kernel_resblocks=False,
                   fuse_pointwise=0)
INT8_STEMS = ("off", "stem3", "full")
PATH_A = dict(kernel_stem=True, kernel_stage1=True, kernel_resblocks=True,
              fuse_pointwise=0)
PATH_B = dict(kernel_stem=True, kernel_stage1=True, kernel_resblocks=False,
              fuse_pointwise=1)

# Minimum bottleneck width for K5 (identity runs with cm ≥ this). Module-level so
# tests can lower it to reach K5 on narrow trunks.
PALLAS_RESBLOCKS_MIN_CM = 128


def _block_names(stage_sizes: Sequence[int]):
    for stage, n in enumerate(stage_sizes):
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            yield f"layer{stage + 1}_{b}", stride


def _sd_prefix(name: str) -> str:
    """JAX tree name → the port's state_dict prefix (openai/CLIP and torchvision names:
    "stem" is torchvision's `conv1`)."""
    stems = {"stem": "conv1", "stem1": "conv1", "stem2": "conv2", "stem3": "conv3"}
    if name in stems:
        return stems[name]
    block, conv = name.split("/")
    stage, b = block[len("layer"):].split("_")
    conv = "downsample.0" if conv == "down" else "conv" + conv[len("cb"):]
    return f"layer{stage}.{b}.{conv}"


_INV_QMAX = float(np.float32(1.0) / np.float32(QMAX))


def _per_tensor_scale(m: torch.Tensor) -> torch.Tensor:
    """max / 127 + 1e-30 in f32, as the JAX package computes it under jit: XLA turns
    the division by the constant 127 into a multiply by its f32 reciprocal."""
    return m.float() * _INV_QMAX + 1e-30


def _nhwc_conv(x: torch.Tensor, weight: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NHWC x, OIHW weight → NHWC, 'SAME' padding; runs on a channels-last view."""
    k = weight.shape[-1]
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, None, stride, k // 2)
    return y.permute(0, 2, 3, 1)


# --------------------------------------------------------------------- calibration


def _folded_conv(folded_sd, name, t, stride=1, relu=True):
    """Folded conv `name` (+ bias, relu) on NHWC t in f32, as the calibration runs it."""
    pre = _sd_prefix(name)
    out = _nhwc_conv(t, folded_sd[f"{pre}.weight"].float(), stride)
    out = out + folded_sd[f"{pre}.bias"].float()
    return torch.relu(out) if relu else out


def calibrate_trunk(folded_sd: Mapping[str, torch.Tensor], stage_sizes: Sequence[int],
                    x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Run the folded trunk in f32 on calibration input x (NHWC) and record the scale
    of every tensor the int8 graph quantizes (keys as in the JAX package).

    `folded_sd` is a BN-folded state_dict with the port's (openai) names. The convs
    run in full f32 (TF32 off), as the JAX package's calibration does."""
    scales: Dict[str, torch.Tensor] = {}

    def record(name, t):
        scales[name] = _per_tensor_scale(t.max())

    cb = functools.partial(_folded_conv, folded_sd)

    def pool(t, k):
        return F.avg_pool2d(t.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)

    with full_f32():
        t = cb("stem1", x.float(), 2)
        record("stem1.out", t)
        t = cb("stem2", t)
        record("stem2.out", t)
        t = cb("stem3", t)
        record("stem.out", t)  # pre-pool: the int8 graph requants before the pool
        t = pool(t, 2)
        for name, stride in _block_names(stage_sizes):
            o = cb(f"{name}/cb1", t)
            record(f"{name}/cb2.in", o)
            o = cb(f"{name}/cb2", o)
            record(f"{name}/cb3.in", o)  # pre-pool for stride blocks
            if stride > 1:
                o = pool(o, stride)
            o = cb(f"{name}/cb3", o, relu=False)
            identity = t
            if stride > 1 or t.shape[-1] != o.shape[-1]:
                if stride > 1:
                    identity = pool(identity, stride)
                identity = cb(f"{name}/down", identity, relu=False)
                scales[f"{name}/down.out"] = _per_tensor_scale(identity.abs().max())
            t = torch.relu(o + identity)
            record(f"{name}.out", t)
    return scales


# -------------------------------------------------------------------- quantization


def _quantize_kernel(kernel_hwio: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric s8 weights (round half to even, as jnp.round)."""
    k = kernel_hwio.float()
    scale = _per_tensor_scale(k.abs().amax(dim=(0, 1, 2)))
    q = torch.clamp(torch.round(k / scale), -QMAX, QMAX).to(torch.int8)
    return {"kernel_q": q, "w_scale": scale}


def _hwio(weight_oihw: torch.Tensor) -> torch.Tensor:
    return weight_oihw.float().permute(2, 3, 1, 0).contiguous()


def _fp_entry(folded_sd: Mapping[str, torch.Tensor], name: str) -> Dict[str, torch.Tensor]:
    """A conv that stays in the compute dtype: f32 HWIO kernel and bias."""
    pre = _sd_prefix(name)
    return {"kernel": _hwio(folded_sd[f"{pre}.weight"]),
            "bias": folded_sd[f"{pre}.bias"].float()}


def _s8_entry(folded_sd: Mapping[str, torch.Tensor], name: str) -> Dict[str, torch.Tensor]:
    """An s8 conv: per-output-channel s8 HWIO kernel, weight scales, f32 bias."""
    pre = _sd_prefix(name)
    return dict(_quantize_kernel(_hwio(folded_sd[f"{pre}.weight"])),
                bias=folded_sd[f"{pre}.bias"].float())


def quantize_trunk(folded_sd: Mapping[str, torch.Tensor], stage_sizes: Sequence[int],
                   calibration_x: torch.Tensor) -> Dict[str, Any]:
    """Folded state_dict → quantized trunk: s8 kernels + per-channel weight scales for
    the bottleneck cb1/cb2/cb3 convs, f32 HWIO kernels for the stem and shortcut
    convs, s8 copies of stem2/stem3 for the int8-stem option (`quantize.py:236-244`),
    and the activation scales calibrated on `calibration_x`."""
    q: Dict[str, Any] = {"act_scales": calibrate_trunk(folded_sd, stage_sizes,
                                                       calibration_x), "fp": {}}
    for name in ("stem1", "stem2", "stem3"):
        q["fp"][name] = _fp_entry(folded_sd, name)
    for name in ("stem2", "stem3"):
        q[name] = _s8_entry(folded_sd, name)
    _quantize_blocks(q, folded_sd, stage_sizes, ("cb1", "cb2", "cb3"))
    return q


def _quantize_blocks(q, folded_sd, stage_sizes, convs) -> None:
    for name, _stride in _block_names(stage_sizes):
        for cbname in convs:
            q[f"{name}/{cbname}"] = _s8_entry(folded_sd, f"{name}/{cbname}")
        if f"{_sd_prefix(name + '/down')}.weight" in folded_sd:
            q["fp"][f"{name}/down"] = _fp_entry(folded_sd, f"{name}/down")


# ------------------------------------------------------------ kernel operand builders
#
# Each scale product is in_scale * w_scale in f32, exactly as qconv computes it, so
# the kernels match the plain graph bit for bit. The JAX builders cast the s8 kernels
# to bf16 for the MXU; the port's kernels take them as s8 on the tensor cores, whose s8
# products read both operands K-major: beside each s8 kernel `k…` (the (K, N) layout the
# plain versions and the JAX package use) the builders keep its K-major copy `k…_t`,
# made once here and cached with the operands.


def _kmajor(k: torch.Tensor) -> torch.Tensor:
    """The (N, K) K-major copy of an s8 kernel: a (K, N) 1×1 kernel transposed; a
    (3, 3, Cin, Cout) one as (Cout, 9·Cin) with k = (ky·3 + kx)·Cin + c."""
    return k.reshape(-1, k.shape[-1]).t().contiguous()


def _with_kmajor(ops: Dict[str, torch.Tensor], *keys: str) -> Dict[str, torch.Tensor]:
    for key in keys:
        ops[f"{key}_t"] = _kmajor(ops[key])
    return ops


def stage1_int8_operands(q: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Operands of K3 (`fused_stage1_int8`): per block a/b/c the 1×1 kernels (Cin,
    Cout), the 3×3 kernel (3,3,Cm,Cm), the epilogue scales S and biases; the bf16
    shortcut pair (wsc, bsc); scl = [s_in, (r2, r3, r_out) × 3, down.out]; each s8
    kernel's K-major copy under its name + "_t"."""
    a = q["act_scales"]
    ops: Dict[str, torch.Tensor] = {}
    s_prev = a["stem.out"]
    scl = [s_prev]
    for name, L in zip(["layer1_0", "layer1_1", "layer1_2"], "abc"):
        s2, s3, s_out = a[f"{name}/cb2.in"], a[f"{name}/cb3.in"], a[f"{name}.out"]
        scl += [s2, s3, s_out]
        cb1, cb2, cb3 = (q[f"{name}/{c}"] for c in ("cb1", "cb2", "cb3"))
        ops[f"k1{L}"] = cb1["kernel_q"][0, 0].contiguous()
        ops[f"s1{L}"] = s_prev * cb1["w_scale"]
        ops[f"b1{L}"] = cb1["bias"]
        ops[f"k2{L}"] = cb2["kernel_q"]
        ops[f"s2{L}"] = s2 * cb2["w_scale"]
        ops[f"b2{L}"] = cb2["bias"]
        ops[f"k3{L}"] = cb3["kernel_q"][0, 0].contiguous()
        ops[f"s3{L}"] = s3 * cb3["w_scale"]
        ops[f"b3{L}"] = cb3["bias"]
        if L == "a":
            down = q["fp"][f"{name}/down"]
            ops["wsc"] = down["kernel"][0, 0].to(torch.bfloat16).contiguous()
            ops["bsc"] = down["bias"]
        s_prev = s_out
    scl.append(a["layer1_0/down.out"])
    ops["scl"] = torch.stack(scl).float()
    return _with_kmajor(ops, *(f"k{i}{L}" for L in "abc" for i in (1, 2, 3)))


def cb3_cb1_operands(q: Dict[str, Any], name: str, next_name: str,
                     r_res: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Operands of K4 (`fused_cb3_cb1_int8`): block `name`'s cb3, block `next_name`'s
    cb1 (with their K-major copies k3_t, k1_t), and scl = [r_res, r_out, r_next]."""
    a = q["act_scales"]
    cb3, cb1n = q[f"{name}/cb3"], q[f"{next_name}/cb1"]
    s_out = a[f"{name}.out"]
    return _with_kmajor({
        "k3": cb3["kernel_q"][0, 0].contiguous(),
        "s3": a[f"{name}/cb3.in"] * cb3["w_scale"],
        "b3": cb3["bias"],
        "k1": cb1n["kernel_q"][0, 0].contiguous(),
        "s1": s_out * cb1n["w_scale"],
        "b1": cb1n["bias"],
        "scl": torch.stack([r_res, s_out, a[f"{next_name}/cb2.in"]]).float(),
    }, "k3", "k1")


def resblocks_int8_operands(q: Dict[str, Any], names: Sequence[str],
                            s_in: torch.Tensor, s_next: torch.Tensor):
    """Operands of K5 (`fused_resblocks_int8`): per-block dicts {k1, s1, b1, k2, s2, b2,
    k3, s3, b3, and the K-major copies k1_t, k2_t, k3_t} and scl = [r_in, (r2, r3,
    r_out) × k], whose last entry is `s_next`."""
    a = q["act_scales"]
    blocks, scl = [], [s_in]
    s_prev = s_in
    for i, name in enumerate(names):
        s2, s3 = a[f"{name}/cb2.in"], a[f"{name}/cb3.in"]
        s_out = s_next if i == len(names) - 1 else a[f"{name}.out"]
        cb1, cb2, cb3 = (q[f"{name}/{c}"] for c in ("cb1", "cb2", "cb3"))
        blocks.append(_with_kmajor({
            "k1": cb1["kernel_q"][0, 0].contiguous(), "s1": s_prev * cb1["w_scale"],
            "b1": cb1["bias"],
            "k2": cb2["kernel_q"], "s2": s2 * cb2["w_scale"], "b2": cb2["bias"],
            "k3": cb3["kernel_q"][0, 0].contiguous(), "s3": s3 * cb3["w_scale"],
            "b3": cb3["bias"],
        }, "k1", "k2", "k3"))
        scl += [s2, s3, s_out]
        s_prev = s_out
    return blocks, torch.stack(scl).float()


def _cached(q: Dict[str, Any], key: tuple, build: Callable[[], Any]):
    cache = q.setdefault("_operands", {})
    if key not in cache:
        cache[key] = build()
    return cache[key]


# --------------------------------------------------------------------------- apply


def _fp_conv(q, name, t, stride=1, relu=True, f32_pointwise=True):
    """The conv of the bf16 operands upcast, run in full f32 with no rounding of its
    output, plus the f32 bias: the CLIP graph's stem convs and the torchvision graph's
    stem and `down` convs, whose bf16 output rounding XLA elides (its optimized HLO holds
    f32 convolutions there, and each such conv's output equals the unrounded f32 conv on
    every element). With `f32_pointwise`, the CLIP graph's 1×1 stride-1 shortcut as an
    f32-accumulating product of bf16 operands (the JAX graph's einsum with
    preferred_element_type=f32)."""
    sub = q["fp"][name]
    k = sub["kernel"].to(torch.bfloat16)
    tb = t.to(torch.bfloat16)
    with full_f32():
        if f32_pointwise and k.shape[0] == 1 and k.shape[1] == 1 and stride == 1:
            out = torch.matmul(tb.float(), k[0, 0].float())
        else:
            out = _nhwc_conv(tb.float(), k.permute(3, 2, 0, 1).float(), stride)
    out = out + sub["bias"]
    return torch.relu(out) if relu else out


def _qconv(sub, t8, in_scale, stride=1):
    """s8 conv → f32 with the bias added; the caller fuses the rest of the epilogue."""
    acc = qconv_acc(t8, sub["kernel_q"], stride)
    return acc.float() * (in_scale * sub["w_scale"]) + sub["bias"]


def _stem(q, x, s_in, kernel_stem, int8_stem, recip):
    """The stem's s8 output (N, H/4, W/4, C) on s_in: `quantize.py:445-493`."""
    a = q["act_scales"]
    if int8_stem not in INT8_STEMS:
        raise ValueError(f"int8_stem must be one of {INT8_STEMS}, got {int8_stem!r}")
    if int8_stem == "full":
        # stem1 stays a bf16 conv (its output unrounded, as XLA leaves it) whose epilogue
        # writes s8; stem2 and stem3 are s8 convs.
        s1, s2 = a["stem1.out"], a["stem2.out"]
        t8 = requant(_fp_conv(q, "stem1", x, 2, relu=False), s1, recip)
        t8 = requant(_qconv(q["stem2"], t8, s1), s2, recip)
        return avg_pool_int8(requant(_qconv(q["stem3"], t8, s2), s_in, recip), 2)
    t = _fp_conv(q, "stem1", x, 2)
    t = _fp_conv(q, "stem2", t)
    if int8_stem == "stem3":
        s2 = a["stem2.out"]
        t8 = requant(t, s2, recip)
        return avg_pool_int8(requant(_qconv(q["stem3"], t8, s2), s_in, recip), 2)
    if kernel_stem and t.shape[1] % 2 == 0 and t.shape[2] % 2 == 0:
        sub = q["fp"]["stem3"]
        return SK.stem3_requant_pool_int8(
            t.to(torch.bfloat16).contiguous(), sub["kernel"], sub["bias"], s_in,
            wmat=_cached(q, ("stem3",), lambda: SK.stem3_weight_matrix(sub["kernel"])),
            recip=recip)
    return avg_pool_int8(requant(_fp_conv(q, "stem3", t, relu=False), s_in, recip), 2)


def quantized_trunk_apply(q: Dict[str, Any], x: torch.Tensor, stage_sizes: Sequence[int],
                          out_dtype=torch.bfloat16, kernel_stem: bool = False,
                          kernel_stage1: bool = False, kernel_resblocks: bool = False,
                          fuse_pointwise: int = 0, recip_requant: bool = False,
                          int8_stem: str = "off", int4_stage1: int = 0) -> torch.Tensor:
    """int8 trunk forward: x is the preprocessed NHWC image batch (f32/bf16). Returns
    the NHWC conv map in `out_dtype`. The switches route the pieces the TPU kernels
    computed through K2–K5 (see the module docstring); `fuse_pointwise` > 0 fuses
    every pair whose block output width is ≥ it, and is off under `kernel_resblocks`,
    which owns those blocks. `recip_requant`, `int8_stem` and `int4_stage1` are the
    options of the module docstring; `int4_stage1` is off wherever K3, K5 or K4 runs,
    as in the JAX package, whose kernels own those tensors."""
    a = q["act_scales"]
    rq = recip_requant
    fuse_pointwise = 0 if kernel_resblocks else fuse_pointwise
    if int4_stage1 not in (0, 1, 2):
        raise ValueError(f"int4_stage1 must be 0, 1 or 2, got {int4_stage1!r}")
    if kernel_stage1 or kernel_resblocks or fuse_pointwise:
        int4_stage1 = 0

    s_in = a["stem.out"]
    t8 = _stem(q, x, s_in, kernel_stem, int8_stem, rq)

    blocks = list(_block_names(stage_sizes))
    if kernel_stage1 and stage_sizes[0] == 3:
        t8 = BK.fused_stage1_int8(t8, _cached(q, ("stage1",),
                                              lambda: stage1_int8_operands(q)), recip=rq)
        s_in = a["layer1_2.out"]
        blocks = blocks[3:]

    def identity_run(i):
        """Length of the run of stride-1 identity blocks with cm ≥ the gate from i."""
        j = i
        while (j < len(blocks) and blocks[j][1] == 1
               and f"{blocks[j][0]}/down" not in q["fp"]
               and (q[f"{blocks[j][0]}/cb2"]["kernel_q"].shape[-1]
                    >= PALLAS_RESBLOCKS_MIN_CM)):
            j += 1
        return j - i

    i = 0
    q1_carry = None  # the next block's cb1 output (s8), made by K4
    while i < len(blocks):
        name, stride = blocks[i]
        if kernel_resblocks and (run := identity_run(i)) > 0:
            names = [blocks[i + k][0] for k in range(run)]
            is_final = i + run == len(blocks)
            # The final run writes the conv map: its last requant scale is unused.
            s_next = torch.ones_like(s_in) if is_final else a[f"{names[-1]}.out"]
            ops, scl = _cached(q, ("resblocks", tuple(names)),
                               lambda: resblocks_int8_operands(q, names, s_in, s_next))
            if is_final:
                return BK.fused_resblocks_int8(t8, ops, scl, out_dtype=out_dtype, recip=rq)
            t8 = BK.fused_resblocks_int8(t8, ops, scl, recip=rq)
            s_in = s_next
            i += run
            continue

        # int4 stage 1: narrow4 the cb2/cb3 inputs, wide4 the block outputs and the
        # shortcut, on the 4-bit grid of their calibrated scales.
        in_stage1 = name.startswith("layer1_")
        narrow4 = int4_stage1 == 1 and in_stage1
        wide4 = int4_stage1 in (1, 2) and in_stage1

        # cb1/cb2 relus fold into the next requant's clip at 0.
        if q1_carry is not None:
            q18, q1_carry = q1_carry, None
            s2 = a[f"{name}/cb2.in"]
        elif narrow4:
            q18, s2 = requant_u4(_qconv(q[f"{name}/cb1"], t8, s_in), a[f"{name}/cb2.in"], rq)
        else:
            s2 = a[f"{name}/cb2.in"]
            q18 = requant(_qconv(q[f"{name}/cb1"], t8, s_in), s2, rq)
        o = _qconv(q[f"{name}/cb2"], q18, s2)
        if narrow4:
            o8, s3 = requant_u4(o, a[f"{name}/cb3.in"], rq)
        else:
            s3 = a[f"{name}/cb3.in"]
            o8 = requant(o, s3, rq)  # pre-pool for stride blocks
        if stride > 1:
            o8 = avg_pool_int8(o8, stride)

        if f"{name}/down" in q["fp"]:
            # Shortcut on the int8 grid: exact integer pool of the s8 input, the bf16
            # 1×1 conv, its output requantized to s8 on a signed per-tensor scale.
            idsrc = avg_pool_int8(t8, stride) if stride > 1 else t8
            down = _fp_conv(q, f"{name}/down", idsrc.float() * s_in, relu=False)
            if wide4:
                id8, r_res = requant_s4(down, a[f"{name}/down.out"], rq)
            else:
                r_res = a[f"{name}/down.out"]
                id8 = requant_signed(down, r_res, rq)
        else:
            id8, r_res = t8, s_in

        is_last = name == blocks[-1][0]
        c_out = q[f"{name}/cb3"]["kernel_q"].shape[-1]
        if fuse_pointwise and c_out >= fuse_pointwise and not is_last:
            next_name = blocks[i + 1][0]
            ops = _cached(q, ("cb3_cb1", name, next_name),
                          lambda: cb3_cb1_operands(q, name, next_name, r_res))
            t8, q1_carry = BK.fused_cb3_cb1_int8(o8, id8, ops, recip=rq)
            s_in = a[f"{name}.out"]
            i += 1
            continue

        o = _qconv(q[f"{name}/cb3"], o8, s3)
        identity = id8.float() * r_res
        if is_last:
            return torch.relu(o + identity).to(out_dtype)
        if wide4:
            t8, s_in = requant_u4(o + identity, a[f"{name}.out"], rq)
        else:
            s_in = a[f"{name}.out"]
            t8 = requant(o + identity, s_in, rq)  # the block relu is the clip at 0
        i += 1
    raise ValueError(f"stage_sizes {tuple(stage_sizes)} leave no block after stage 1")


# ------------------------------------------------------ torchvision ResNet (imagenet)


def _resnet_convs(block: str):
    return ("cb1", "cb2", "cb3") if block == "bottleneck" else ("cb1", "cb2")


def calibrate_resnet_trunk(folded_sd: Mapping[str, torch.Tensor], stage_sizes: Sequence[int],
                           block: str, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """`calibrate_trunk` for the torchvision trunk (`quantize.py:627-665`): the folded
    trunk in full f32 on x (NHWC), recording the stem output before the max pool, each
    block's conv inputs and output, and the shortcut's |max|."""
    scales: Dict[str, torch.Tensor] = {}

    def record(name, t):
        scales[name] = _per_tensor_scale(t.max())

    cb = functools.partial(_folded_conv, folded_sd)
    with full_f32():
        t = cb("stem", x.float(), 2)
        record("stem.out", t)  # pre-pool: the int8 graph pools on the int8 grid
        t = F.max_pool2d(t.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for name, stride in _block_names(stage_sizes):
            if block == "bottleneck":
                o = cb(f"{name}/cb1", t)
                record(f"{name}/cb2.in", o)
                o = cb(f"{name}/cb2", o, stride)
                record(f"{name}/cb3.in", o)
                o = cb(f"{name}/cb3", o, relu=False)
            else:
                o = cb(f"{name}/cb1", t, stride)
                record(f"{name}/cb2.in", o)
                o = cb(f"{name}/cb2", o, relu=False)
            identity = t
            if stride > 1 or t.shape[-1] != o.shape[-1]:
                identity = cb(f"{name}/down", identity, stride, relu=False)
                scales[f"{name}/down.out"] = _per_tensor_scale(identity.abs().max())
            t = torch.relu(o + identity)
            record(f"{name}.out", t)
    return scales


def quantize_resnet_trunk(folded_sd: Mapping[str, torch.Tensor], stage_sizes: Sequence[int],
                          block: str, calibration_x: torch.Tensor) -> Dict[str, Any]:
    """Folded torchvision state_dict → quantized trunk: s8 block convs, f32 stem and
    shortcut convs (kept for bf16), activation scales calibrated on `calibration_x`."""
    q: Dict[str, Any] = {
        "act_scales": calibrate_resnet_trunk(folded_sd, stage_sizes, block, calibration_x),
        "fp": {"stem": _fp_entry(folded_sd, "stem")}}
    _quantize_blocks(q, folded_sd, stage_sizes, _resnet_convs(block))
    return q


def quantized_resnet_apply(q: Dict[str, Any], x: torch.Tensor, stage_sizes: Sequence[int],
                           block: str, out_dtype=torch.bfloat16,
                           recip_requant: bool = False) -> torch.Tensor:
    """int8 torchvision-ResNet forward (`quantize.py:685-738`): x is the preprocessed
    NHWC batch; returns the NHWC conv map in `out_dtype`. The stem and the shortcut
    convs take bf16 operands and give unrounded f32 outputs: the JAX graph casts their
    bf16 results to f32, and XLA leaves them unrounded (as the CLIP stems' in
    `_fp_conv`); relus fold into the requants' clip at 0. `recip_requant` is the
    reciprocal requant (`ops/int8.py`)."""
    a = q["act_scales"]
    rq = recip_requant
    s_in = a["stem.out"]
    t8 = max_pool_int8(requant(_fp_conv(q, "stem", x, 2, relu=False), s_in, rq))
    blocks = list(_block_names(stage_sizes))
    for name, stride in blocks:
        s2 = a[f"{name}/cb2.in"]
        if block == "bottleneck":
            o = _qconv(q[f"{name}/cb1"], t8, s_in)
            o = _qconv(q[f"{name}/cb2"], requant(o, s2, rq), s2, stride)
            s3 = a[f"{name}/cb3.in"]
            o = _qconv(q[f"{name}/cb3"], requant(o, s3, rq), s3)
        else:
            o = _qconv(q[f"{name}/cb1"], t8, s_in, stride)
            o = _qconv(q[f"{name}/cb2"], requant(o, s2, rq), s2)
        if f"{name}/down" in q["fp"]:
            down = _fp_conv(q, f"{name}/down", t8.float() * s_in, stride, relu=False,
                            f32_pointwise=False)
            ds = a[f"{name}/down.out"]
            identity = requant_signed(down, ds, rq).float() * ds
        else:
            identity = t8.float() * s_in
        if name == blocks[-1][0]:
            return torch.relu(o + identity).to(out_dtype)
        s_in = a[f"{name}.out"]
        t8 = requant(o + identity, s_in, rq)
    raise ValueError(f"stage_sizes {tuple(stage_sizes)} have no block")
