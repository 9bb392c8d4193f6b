"""Probe evaluation metrics on tensors (port of `embodied_clip_tpu/utils/metrics.py`).

Parity targets (reference train.py:84-90):
  - object_presence / object_localization: torchmetrics.functional.f1(pred, y) — the
    pinned torchmetrics default is MICRO-averaged F1 over predictions binarized at 0.5.
  - reachability: ((y_pred > 0.5) == y).float().mean()
  - free_space: (argmax(y_pred, dim=1) == y).float().mean()

Each returns a 0-dim f32 tensor on its inputs' device (no host sync).
"""

from __future__ import annotations

import torch

__all__ = ["f1_score", "binary_accuracy", "argmax_accuracy"]


def f1_score(probs: torch.Tensor, targets: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Micro-averaged F1 over binarized probabilities (torchmetrics.functional.f1
    default); 0 where 2·tp + fp + fn = 0."""
    pred = (probs > threshold).float()
    t = targets.float()
    tp = torch.sum(pred * t)
    fp = torch.sum(pred * (1.0 - t))
    fn = torch.sum((1.0 - pred) * t)
    denom = 2.0 * tp + fp + fn
    return torch.where(denom > 0, 2.0 * tp / denom, torch.zeros_like(denom))


def binary_accuracy(probs: torch.Tensor, targets: torch.Tensor,
                    threshold: float = 0.5) -> torch.Tensor:
    return ((probs > threshold) == (targets > 0.5)).float().mean()


def argmax_accuracy(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(probs, dim=1) == labels).float().mean()
