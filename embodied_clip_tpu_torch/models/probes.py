"""Navigational-primitive probe heads, losses and metrics (port of
`embodied_clip_tpu/models/probes.py`).

The reference's LinearEncoder (train.py:14-113) as `nn.Module`s and plain loss
functions:

  object_presence      Linear(D → 52) + sigmoid, BCE            (train.py:27-29,76)
  reachability         Linear(D → 110) + sigmoid, per-sample object-indexed BCE
                                                                 (train.py:30-32,61-63,71-72)
  free_space           Linear(D → 11) + softmax, then F.cross_entropy *on the softmax
                       output* — the reference double-softmax quirk is kept
                                                                 (train.py:33-35,64-65,78)
  object_localization  AdaptiveAvgPool2d(3,3) → 1x1 conv(2048→52) + sigmoid over the
                       9 cells, BCE                              (train.py:42-49,59,69-70)

Valid (embedding × prediction) combos and input dims mirror train.py:19-25,43: pooled
probes take imagenet_avgpool/clip_avgpool (2048) or clip_attnpool (1024); localization
takes the conv map, NHWC (the data layer remaps *_avgpool → *_conv). The heads return
logits, in f32; the activation is folded into the loss. Their weights are drawn as flax
draws a `Dense` (truncated LeCun-normal kernel, zero bias) from an explicit
`torch.Generator`; `models/convert.from_flax_probe_params` carries JAX params across.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from embodied_clip_tpu_torch.constants import MAX_FORWARD_STEPS, TARGET_OBJECTS
from embodied_clip_tpu_torch.utils.metrics import argmax_accuracy, binary_accuracy, f1_score

__all__ = [
    "PREDICTION_TYPES", "EMBEDDING_TYPES", "EMBEDDING_DIMS", "validate_combo",
    "PooledProbe", "LocalizationProbe", "build_probe",
    "probe_loss", "probe_metrics", "adaptive_avg_pool",
]

PREDICTION_TYPES = ("object_presence", "object_localization", "reachability", "free_space")
EMBEDDING_TYPES = ("imagenet_avgpool", "clip_avgpool", "clip_attnpool")
# Channels of each embedding at the reference's encoders (RN50 trunks, CLIP RN50's
# attention pool); localization probes the 2048-channel conv map of the same trunk.
EMBEDDING_DIMS = {"imagenet_avgpool": 2048, "clip_avgpool": 2048, "clip_attnpool": 1024}

_POOLED_OUT = {
    "object_presence": len(TARGET_OBJECTS),
    "reachability": 110,
    "free_space": MAX_FORWARD_STEPS + 1,
}


def validate_combo(embedding_type: str, prediction_type: str) -> None:
    assert prediction_type in PREDICTION_TYPES, prediction_type
    if prediction_type == "object_localization":
        assert embedding_type in ("imagenet_avgpool", "clip_avgpool"), (
            "localization probes the conv map of avgpool-style encoders (train.py:43)"
        )
    else:
        assert embedding_type in EMBEDDING_TYPES, embedding_type


def _flax_dense_init_(linear: nn.Linear, generator: Optional[torch.Generator]) -> None:
    """flax `Dense` defaults: a normal of variance 1/fan_in truncated at ±2σ, zero bias."""
    std = (1.0 / linear.in_features) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(linear.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        nn.init.zeros_(linear.bias)


class PooledProbe(nn.Module):
    """One linear layer over a pooled embedding (N, D); returns logits (N, out)."""

    def __init__(self, in_features: int, output_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.linear = nn.Linear(in_features, output_dim)
        _flax_dense_init_(self.linear, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x.float())


def adaptive_avg_pool(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """torch AdaptiveAvgPool2d semantics on NHWC: bin i spans
    [floor(i·H/O), ceil((i+1)·H/O)). Returns (N, oh, ow, C), each bin's mean taken as
    the JAX package takes it."""
    n, h, w, c = x.shape
    oh, ow = out_hw
    rows = []
    for i in range(oh):
        r0, r1 = (i * h) // oh, -(-((i + 1) * h) // oh)
        cols = []
        for j in range(ow):
            c0, c1 = (j * w) // ow, -(-((j + 1) * w) // ow)
            cols.append(torch.mean(x[:, r0:r1, c0:c1, :], dim=(1, 2)))
        rows.append(torch.stack(cols, dim=1))
    return torch.stack(rows, dim=1)


class LocalizationProbe(nn.Module):
    """Adaptive 3×3 pool + 1×1 conv (a per-cell linear layer) over the NHWC conv map;
    returns logits (N, 9, num_classes), cell-major as the reference's
    permute(0,2,1).flatten ordering (train.py:69-70)."""

    def __init__(self, in_features: int, num_classes: int = len(TARGET_OBJECTS),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.cell_linear = nn.Linear(in_features, num_classes)
        _flax_dense_init_(self.cell_linear, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cell_linear(adaptive_avg_pool(x.float(), (3, 3)))
        return x.reshape(x.shape[0], 9, self.num_classes)


def build_probe(embedding_type: str, prediction_type: str,
                in_features: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """The probe for the combo, on the CPU in f32; `in_features` defaults to the
    reference encoders' width (`EMBEDDING_DIMS`)."""
    validate_combo(embedding_type, prediction_type)
    d = EMBEDDING_DIMS[embedding_type] if in_features is None else in_features
    if prediction_type == "object_localization":
        return LocalizationProbe(d, generator=generator)
    return PooledProbe(d, _POOLED_OUT[prediction_type], generator=generator)


# ------------------------------------------------------------------ losses / metrics


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    # == torch F.binary_cross_entropy(sigmoid(logits), targets), mean reduction, in
    # the JAX package's form.
    t = targets.float()
    return torch.mean(torch.clamp(logits, min=0) - logits * t
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def _selected(logits: torch.Tensor, obj_idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(logits, 1, obj_idx.long()[:, None])[:, 0]


def probe_loss(prediction_type: str, logits: torch.Tensor, labels) -> torch.Tensor:
    """Loss with reference-exact semantics. `labels`: presence (N,52); localization
    (N,9,52) or (N,3,3,52); reachability (obj_idx (N,), y (N,)); free_space (N,)."""
    if prediction_type == "object_presence":
        return _bce_with_logits(logits, labels)
    if prediction_type == "object_localization":
        return _bce_with_logits(logits, labels.reshape(labels.shape[0], 9, -1))
    if prediction_type == "reachability":
        obj_idx, y = labels
        return _bce_with_logits(_selected(logits, obj_idx), y)
    if prediction_type == "free_space":
        y = torch.clamp(labels, max=MAX_FORWARD_STEPS).long()  # train.py:64-65
        # Reference quirk (train.py:35,78): CE applied to softmax *probabilities*.
        logp = F.log_softmax(F.softmax(logits, dim=1), dim=1)
        return -torch.mean(torch.gather(logp, 1, y[:, None]))
    raise ValueError(prediction_type)


def probe_metrics(prediction_type: str, logits: torch.Tensor, labels):
    """{"accuracy": 0-dim tensor}, per reference train.py:84-90."""
    if prediction_type in ("object_presence", "object_localization"):
        if prediction_type == "object_localization":
            labels = labels.reshape(labels.shape[0], 9, -1)
        return {"accuracy": f1_score(torch.sigmoid(logits), labels)}
    if prediction_type == "reachability":
        obj_idx, y = labels
        return {"accuracy": binary_accuracy(torch.sigmoid(_selected(logits, obj_idx)), y)}
    if prediction_type == "free_space":
        y = torch.clamp(labels, max=MAX_FORWARD_STEPS).long()
        return {"accuracy": argmax_accuracy(logits, y)}
    raise ValueError(prediction_type)
