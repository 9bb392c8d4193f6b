"""Shared parity helpers (copy of `embodied_clip_tpu/parity.py:33-63`): the golden
frames both packages encode, and the per-sample cosine distance the north star
(features within 1e-3 of the f32 reference, BASELINE.json) is stated in."""

from __future__ import annotations

import numpy as np

__all__ = ["golden_frames", "cosine_distance"]


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
