"""Shared parity helpers (copy of `embodied_clip_tpu/parity.py:33-63`): the golden
frames both packages encode, and the per-sample cosine distance the north star
(features within 1e-3 of the f32 reference, BASELINE.json) is stated in. Also the
contract the bf16 kernels K6/K7 are held to against their plain versions on the card."""

from __future__ import annotations

import numpy as np

__all__ = ["golden_frames", "cosine_distance", "bf16_disagreement",
           "stage1_block_disagreements", "BF16_KERNEL_RTOL", "BF16_KERNEL_SHARE"]

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
BF16_KERNEL_RTOL = 2.0 ** -6
BF16_KERNEL_SHARE = 0.01


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


def bf16_disagreement(got, want):
    """(share of elements that differ, worst |got - want| over its allowance
    rtol·|want| + rtol·RMS(want)) of two tensors; the contract holds when the share is
    ≤ BF16_KERNEL_SHARE and the worst ratio ≤ 1."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    rms = want.square().mean().sqrt()
    allow = BF16_KERNEL_RTOL * (want.abs() + rms)
    return float((diff != 0).float().mean()), float((diff / allow).max())


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
