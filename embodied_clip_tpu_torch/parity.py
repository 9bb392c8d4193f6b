"""Shared parity helpers (port of `embodied_clip_tpu/parity.py`): the golden frames
both packages encode, the per-sample cosine distance the north star (features within
1e-3 of the f32 reference, BASELINE.json) is stated in, and the real-weight parity check
`verify_encoder_parity`. Also the contracts the bf16 kernels K6/K7 and the int8 stride
block are held to against their plain versions on the card.

The parity check's two halves: tools/capture_reference_activations.py runs wherever the
reference stack lives and saves the golden frames' activations to an .npz; then
`python -m embodied_clip_tpu_torch verify-parity --encoder clip_rn50 --torch-checkpoint
RN50_state_dict.pt --activations ref_acts.npz` loads the same weights into the port,
encodes the same frames on the card and holds each key's cosine distance to the
threshold."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["golden_frames", "cosine_distance", "verify_encoder_parity", "bf16_disagreement",
           "bf16_share_limit", "stage1_block_disagreements", "stride_block_disagreement",
           "stem12_step_disagreement", "layer_norm_step_disagreement", "BF16_KERNEL_RTOL",
           "BF16_KERNEL_SHARE", "BF16_SHARE_REF_TERMS", "STEM12_SHARE", "STEM12_STEPS",
           "LN_SHARE", "LN_STEPS", "LN_STEP_FLOOR"]

# K6/K7 vs their plain versions, both bf16 with f32 accumulation: at most 1% of output
# elements differ, each by at most two bf16 steps (rtol 2⁻⁶) with atol 2⁻⁶ × the
# output's RMS. The f32 sum order flips bf16 roundings of h1/h2 on near-ties. K7 chains
# blocks through bf16 block outputs, and a flipped rounding there moves ~100 elements of
# the next block (its 3×3 spreads it over 9 pixels × C channels) and carries through
# every residual add after it: the plain version against a float64 copy of itself
# differs on 1.2% of an RN50 stage-1 output, 0.012% of block 0's, and on the card a
# chained difference reached 1.8× the two-step allowance where a later block's residual
# add cancels. So K7 is held block by block (`stage1_block_disagreements`); its chained
# output is reported, not limited.
#
# The share of near-tie flips grows with the length of the f32 reductions: at RN50x16's
# stage 4 (a 3×3 conv over 768 channels, 6,912 terms) the plain version itself differs
# from the same arithmetic accumulated in float64 on up to 1.17% of a block's output,
# and the kernel on up to 1.13% (an H100, batch 8 at 384 px). So the share limit is 1% up to
# RN50's longest reduction (stage 4's 3×3 conv, 9·512 = 4,608 terms) and grows in
# proportion beyond it (`bf16_share_limit`).
BF16_KERNEL_RTOL = 2.0 ** -6
BF16_KERNEL_SHARE = 0.01
BF16_SHARE_REF_TERMS = 9 * 512

# The stem12 launch vs its plain version (`stem12_step_disagreement`): the same f32
# products of the same bf16-rounded operands, summed in another order only (about 1e-7 of
# the terms' scale against bf16's 2^-8 step), so at most 0.1% of the bf16 outputs differ,
# each by at most one step. Near a cancellation (an output close to zero, at ReLU's edge)
# that difference is many steps of the tiny value, so a step is counted at no less than
# the output's RMS.
STEM12_SHARE = 1e-3
STEM12_STEPS = 1.0
# The LayerNorm launch (`ops/kernels/pointwise_kernel.py`) against its plain chain,
# `layer_norm_f32(x, ln).to(bf16)`: the same f32 arithmetic but for the order of the
# statistics' sums (the row's sum, then its centred squares, against PyTorch's Welford),
# a few f32 ulps of the mean and 1/σ (~1e-7 of an output), which can move an output to the
# neighbouring bf16 value: at most 0.1% of the outputs, each by one step. Near zero that
# is more than a step of the tiny value, so a step is counted at no less than 2^-10.
LN_SHARE = 1e-3
LN_STEPS = 1.0
LN_STEP_FLOOR = 2.0 ** -10


def golden_frames(n: int = 8, size: int = 300, seed: int = 0) -> np.ndarray:
    """Deterministic uint8 NHWC frames: smooth gradients (bicubic-resize fidelity)
    mixed with structured noise (the full activation range)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size),
                         indexing="ij")
    frames = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        phase = rng.uniform(0, 2 * np.pi, 3)
        freq = rng.uniform(1.0, 6.0, 3)
        smooth = np.stack(
            [0.5 + 0.5 * np.sin(2 * np.pi * f * (yy * rng.rand() + xx * rng.rand())
                                + p) for f, p in zip(freq, phase)], axis=-1)
        noise = rng.rand(size, size, 3)
        alpha = rng.uniform(0.2, 0.8)
        img = alpha * smooth + (1 - alpha) * noise
        frames[i] = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    return frames


def cosine_distance(a, b) -> float:
    """Max per-sample cosine distance between feature batches (flattened per row).
    Takes numpy arrays or tensors (any device, any float dtype)."""
    a, b = (np.asarray(v.detach().float().cpu() if hasattr(v, "detach") else v,
                       np.float64) for v in (a, b))
    a = a.reshape(a.shape[0], -1)
    b = b.reshape(b.shape[0], -1)
    num = (a * b).sum(-1)
    den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-30
    return float((1.0 - num / den).max())


def _to_nhwc(x: np.ndarray) -> np.ndarray:
    """Accept reference conv maps in either NCHW (torch-native) or NHWC."""
    if x.ndim == 4 and x.shape[1] > x.shape[-1]:
        return np.transpose(x, (0, 2, 3, 1))
    return x


def _with_state_dict(enc, sd):
    """`enc`'s spec and dtype on `sd`, the state dict `convert-weights` wrote: folded
    (no BN statistics, where the encoder has them) or not."""
    from embodied_clip_tpu_torch.models.encoders import FrozenEncoder, _make_module

    has_bn = any(k.endswith("running_mean") for k in enc.module.state_dict())
    folded = has_bn and not any(k.endswith("running_mean") for k in sd)
    module = _make_module(enc.spec, enc.dtype, folded, sd, enc.device)
    return FrozenEncoder(enc.spec, module, enc.image_size, enc.dtype, enc.device)


def verify_encoder_parity(
    encoder_name: str,
    activations_path: str,
    torch_checkpoint: Optional[str] = None,
    variables: Optional[str] = None,
    dtype: str = "float32",
    threshold: float = 1e-3,
    device="cuda",
) -> Dict[str, object]:
    """Encode the captured frames with the port's encoder on `device`; compare per key.

    The weights come from `torch_checkpoint` (a reference state_dict or jit archive) or
    `variables` (the state-dict file `convert-weights` writes, folded or not), else the
    seed-0 random init. `int8` runs the serving graph: bf16, BN folded, int8 PTQ
    calibrated on the capture's own frames. Returns {"pass": bool,
    "per_key_cosine_distance": {key: distance}, "worst", ...}. Keys compared are the
    intersection of the capture's keys and ours (conv maps accepted NCHW or NHWC)."""
    import torch

    from embodied_clip_tpu_torch.models.encoders import build_encoder

    with np.load(activations_path) as z:
        frames = z["__frames__"]
        ref = {k: z[k] for k in z.files if not k.startswith("__")}

    if dtype not in ("float32", "bfloat16", "int8"):
        raise ValueError(f"unsupported parity dtype {dtype!r}")
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    enc = build_encoder(encoder_name, dtype=tdt, torch_checkpoint=torch_checkpoint,
                        device=device)
    if variables is not None:
        from embodied_clip_tpu_torch.utils.checkpoint import restore_pytree

        enc = _with_state_dict(enc, restore_pytree(variables))
    if dtype == "int8":
        enc = enc.fold_bn().quantize(frames)
    ours = {k: v.float().cpu().numpy() for k, v in enc.encode(frames).items()}

    per_key = {}
    for k in sorted(set(ref) & set(ours)):
        per_key[k] = cosine_distance(_to_nhwc(ref[k]), _to_nhwc(ours[k]))
    if not per_key:
        raise ValueError(
            f"no comparable keys: capture has {sorted(ref)}, encoder emits {sorted(ours)}"
        )
    worst = max(per_key.values())
    return {
        "encoder": encoder_name,
        "dtype": dtype,
        "threshold": threshold,
        "per_key_cosine_distance": per_key,
        "worst": worst,
        "pass": bool(worst <= threshold),
        "frames": int(frames.shape[0]),
    }


def bf16_disagreement(got, want):
    """(share of elements that differ, worst |got - want| over its allowance
    rtol·|want| + rtol·RMS(want)) of two tensors; the contract holds when the share is
    ≤ BF16_KERNEL_SHARE and the worst ratio ≤ 1."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    rms = want.square().mean().sqrt()
    allow = BF16_KERNEL_RTOL * (want.abs() + rms)
    return float((diff != 0).float().mean()), float((diff / allow).max())


def stem12_step_disagreement(got, want):
    """(share of elements that differ, worst difference in bf16 steps) of two tensors on
    the bf16 grid, a difference counted in steps at the larger of |got|, |want| and
    RMS(want); the stem12 contract holds when the share is ≤ STEM12_SHARE and the worst
    ≤ STEM12_STEPS."""
    return _step_disagreement(got, want, float(want.float().square().mean().sqrt()))


def layer_norm_step_disagreement(got, want):
    """(share of elements that differ, worst difference in bf16 steps) of two tensors on
    the bf16 grid, a difference counted in steps at the larger of |got|, |want| and
    LN_STEP_FLOOR; the LayerNorm contract holds when the share is ≤ LN_SHARE and the
    worst ≤ LN_STEPS."""
    return _step_disagreement(got, want, LN_STEP_FLOOR)


def _step_disagreement(got, want, floor: float):
    """(share of elements that differ, worst difference in bf16 steps at the larger of
    |got|, |want| and `floor`)."""
    import torch

    got, want = got.float(), want.float()
    diff = (got - want).abs()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(floor)
    step = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    return float((diff != 0).float().mean()), float((diff / step).max())


def bf16_share_limit(blocks) -> float:
    """The share of elements a K6/K7 call on `blocks` (dicts of w1 (Cin, Cm), w2 HWIO,
    w3 (Cm, Cout)) may differ on: BF16_KERNEL_SHARE, scaled by the call's longest
    reduction over BF16_SHARE_REF_TERMS where it is longer."""
    terms = max(max(b["w1"].shape[0], b["w2"][..., 0].numel(), b["w3"].shape[0])
                for b in blocks)
    return BF16_KERNEL_SHARE * max(1.0, terms / BF16_SHARE_REF_TERMS)


def stage1_block_disagreements(x, blocks, shortcut):
    """K7 block by block, on the card: for k = 1 … len(blocks), `bf16_disagreement` of
    the kernel's output after k blocks against the plain version of block k run on the
    kernel's own output after k - 1 blocks (the kernel is deterministic, so that is the
    input block k had inside the longer call). Launches K7 once per block."""
    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK

    out, prev = [], None
    for k in range(1, len(blocks) + 1):
        got = BK.fused_stage1(x, blocks[:k], shortcut)
        want = (BK.fused_stage1_reference(x, blocks[:1], shortcut) if k == 1
                else BK.fused_bottleneck_reference(prev, **blocks[k - 1]))
        out.append(bf16_disagreement(got, want))
        prev = got
    return out


def stride_block_disagreement(x8, ops, recip=False, out_dtype=None, cb3=True, q1=None):
    """The stride block's contract, on the card, for one call of
    `fused_stride_block_int8(x8, ops, recip, out_dtype, cb3, q1)`: the kernel's (o8, id8)
    (a launch with `cb3` False) against the plain version's, o8 to be equal on every
    element and id8 within ≤1 s8 step on ≤0.5% (the plain shortcut's f32 sum order);
    id8 against the exact sum's requant (`_shortcut_reference` of the pooled input, which
    the kernel's shortcut equals on every element; the plain version's f32 product may
    differ from it on a near-tie); with `cb3`, the kernel's output against the plain cb3
    of the kernel's own o8 and id8 (the kernel is deterministic, so those are the inputs
    its cb3 had inside the whole call), to be equal. Returns {"o8_equal", "id8_step",
    "id8_share", "id8_exact", "cb3_equal" (None without `cb3`), "out" (the kernel's
    output; (o8, id8) without `cb3`), "plain" (the plain version's)}. Launches the block
    once more with `cb3`."""
    import torch

    from embodied_clip_tpu_torch.ops.int8 import avg_pool_int8
    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK

    out_dtype = torch.int8 if out_dtype is None else out_dtype
    o8, id8 = BK.fused_stride_block_int8(x8, ops, recip, cb3=False, q1=q1)
    want = BK.fused_stride_block_int8_reference(x8, ops, recip, cb3=False, q1=q1)
    scl = ops["scl"]
    exact = BK._shortcut_reference(avg_pool_int8(x8, 2), ops["wsc"], ops["bsc"], scl[0],
                                   scl[3], recip)
    d = (id8.int() - want[1].int()).abs()
    res = {"o8_equal": bool(torch.equal(o8, want[0])), "id8_step": int(d.max()),
           "id8_share": float((d != 0).float().mean()),
           "id8_exact": bool(torch.equal(id8, exact)), "cb3_equal": None,
           "out": (o8, id8), "plain": want}
    if cb3:
        got = BK.fused_stride_block_int8(x8, ops, recip, out_dtype, q1=q1)
        cb3_want = BK._stride_cb3_reference(o8, id8, ops, recip, out_dtype)
        res.update(cb3_equal=bool(torch.equal(got, cb3_want)), out=got,
                   plain=BK.fused_stride_block_int8_reference(x8, ops, recip, out_dtype, q1=q1))
    return res
