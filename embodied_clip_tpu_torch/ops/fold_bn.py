"""Frozen-BatchNorm folding for inference encoders (port of
`embodied_clip_tpu/ops/fold_bn.py:fold_conv_bn_tree`).

At inference BN is a per-channel affine with constant coefficients, so it folds into
the preceding conv:

    scale = γ / sqrt(var + ε)
    W'    = W · scale        (per output channel)
    b'    = β − mean · scale

Here the tree is an openai/CLIP-named state_dict: `…convK` pairs with `…bnK` and
`…downsample.0` with `…downsample.1`. Folding is exact in f32.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["fold_conv_bn_state_dict"]

_EPS = 1e-5
_BN_FIELDS = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")


def _conv_prefix(bn_prefix: str) -> str:
    head, _, leaf = bn_prefix.rpartition(".")
    if leaf.startswith("bn"):
        conv = "conv" + leaf[2:]
    elif leaf == "1" and head.endswith("downsample"):
        conv = "0"
    else:
        raise KeyError(f"no conv pairs with BatchNorm {bn_prefix!r}")
    return f"{head}.{conv}" if head else conv


def fold_conv_bn_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold every conv/BN pair of `sd`; other entries pass through unchanged."""
    bns = [k[: -len(".running_var")] for k in sd if k.endswith(".running_var")]
    bn_keys = {f"{b}.{f}" for b in bns for f in _BN_FIELDS}
    out = {k: v for k, v in sd.items() if k not in bn_keys}
    for bn in bns:
        conv = _conv_prefix(bn)
        gamma, beta, mean, var = (sd[f"{bn}.{f}"].float() for f in _BN_FIELDS[:4])
        scale = gamma * torch.rsqrt(var + _EPS)
        out[f"{conv}.weight"] = sd[f"{conv}.weight"].float() * scale[:, None, None, None]
        out[f"{conv}.bias"] = beta - mean * scale
    return out
