"""Seeded uint8 frames, made on the device in bulk.

A frozen copy of `embodied_clip_tpu_torch/parity.py`'s `golden_frames` distribution
(smooth sinusoidal gradients, which exercise the bicubic resize, mixed with uniform
noise, which covers the full activation range), written for a torch generator so that
a pool of thousands of frames takes milliseconds: per frame and channel a frequency
U(1, 6), a phase U(0, 2pi) and two direction weights U(0, 1); per frame a mix
U(0.2, 0.8).
"""

from __future__ import annotations

import math

import torch


def golden_frames(n: int, h: int, w: int, generator: torch.Generator,
                  chunk: int = 128) -> torch.Tensor:
    """(n, h, w, 3) uint8 frames on the generator's device."""
    dev = generator.device
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=dev)
    yy = torch.linspace(0, 1, h, device=dev)[None, :, None, None]
    xx = torch.linspace(0, 1, w, device=dev)[None, None, :, None]
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        p = torch.rand((m, 10), generator=generator, device=dev)
        freq = (1.0 + 5.0 * p[:, 0:3])[:, None, None, :]
        phase = (2 * math.pi * p[:, 3:6])[:, None, None, :]
        ay, ax = p[:, 6:9][:, None, None, :], torch.rand((m, 1, 1, 3), generator=generator,
                                                          device=dev)
        alpha = (0.2 + 0.6 * p[:, 9])[:, None, None, None]
        smooth = 0.5 + 0.5 * torch.sin(2 * math.pi * freq * (yy * ay + xx * ax) + phase)
        noise = torch.rand((m, h, w, 3), generator=generator, device=dev)
        img = alpha * smooth + (1 - alpha) * noise
        out[lo:lo + m] = (img * 255.0).clamp(0, 255).to(torch.uint8)
    return out
