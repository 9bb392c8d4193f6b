"""Seeded int8 trunk fragments, in numpy, for the port's int8 kernel tests.

The same arrays go to the JAX package (as jnp arrays) and to the port (`to_torch`),
so both compute on identical quantized weights and scales. Shaped like
`tests/test_bottleneck_kernel.py`'s fixtures; imports no JAX (the card's machine has
none).
"""

import numpy as np
import torch


def qk(rng, ci, co, k=1, std=None):
    """A per-output-channel s8 conv: {kernel_q (k,k,ci,co), w_scale, bias}."""
    kern = rng.randn(k, k, ci, co).astype(np.float32) * (
        std if std is not None else 1 / np.sqrt(k * k * ci))
    scale = (np.abs(kern).reshape(-1, co).max(0) / 127.0 + 1e-30).astype(np.float32)
    q = np.clip(np.round(kern / scale), -127, 127).astype(np.int8)
    return {"kernel_q": q, "w_scale": scale,
            "bias": (rng.randn(co) * 0.05).astype(np.float32)}


def stage1_q(rng, cin=64, cm=64, cout=256):
    """RN50-shaped int8 stage 1 (3 blocks, conv shortcut on block 0)."""
    q = {"act_scales": {}, "fp": {}}
    a = q["act_scales"]
    a["stem.out"] = np.float32(2.0 / 127)
    for i, nm in enumerate(["layer1_0", "layer1_1", "layer1_2"]):
        q[f"{nm}/cb1"] = qk(rng, cin if i == 0 else cout, cm, std=0.1)
        q[f"{nm}/cb2"] = qk(rng, cm, cm, 3, std=0.1)
        q[f"{nm}/cb3"] = qk(rng, cm, cout, std=0.1)
        a[f"{nm}/cb2.in"] = np.float32(1.5 / 127)
        a[f"{nm}/cb3.in"] = np.float32(1.2 / 127)
        a[f"{nm}.out"] = np.float32(2.5 / 127)
    q["fp"]["layer1_0/down"] = {"conv": {
        "kernel": rng.randn(1, 1, cin, cout).astype(np.float32) * 0.1,
        "bias": (rng.randn(cout) * 0.05).astype(np.float32)}}
    a["layer1_0/down.out"] = np.float32(1.7 / 127)
    return q


def identity_q(rng, cin, cm, nb, prefix="layer3"):
    """nb stride-1 identity bottlenecks named prefix_1 .. prefix_nb."""
    q = {"act_scales": {}, "fp": {}}
    a = q["act_scales"]
    names = [f"{prefix}_{i}" for i in range(1, nb + 1)]
    for nm in names:
        q[f"{nm}/cb1"] = qk(rng, cin, cm)
        q[f"{nm}/cb2"] = qk(rng, cm, cm, 3)
        q[f"{nm}/cb3"] = qk(rng, cm, cin)
        a[f"{nm}/cb2.in"] = np.float32(1.5 / 127)
        a[f"{nm}/cb3.in"] = np.float32(1.2 / 127)
        a[f"{nm}.out"] = np.float32(2.1 / 127)
    return q, names


def to_torch(qnp, device="cpu"):
    """numpy quantized-trunk fragment → the port's layout (fp convs without the
    "conv" level, scalars as 0-dim f32 tensors)."""
    def t(v):
        return torch.from_numpy(np.array(v)).to(device)

    out = {"act_scales": {k: t(np.float32(v)) for k, v in qnp["act_scales"].items()},
           "fp": {k: {"kernel": t(v["conv"]["kernel"]), "bias": t(v["conv"]["bias"])}
                  for k, v in qnp["fp"].items()}}
    for k, v in qnp.items():
        if "/" in k:
            out[k] = {n: t(a) for n, a in v.items()}
    return out


def s8(rng, shape, hi=90):
    return rng.randint(0, hi, shape).astype(np.int8)


def step_diff(got, want):
    """(max |diff|, share of elements that differ) of two integer arrays/tensors."""
    got = np.asarray(got.cpu() if hasattr(got, "cpu") else got).astype(np.int32)
    want = np.asarray(want.cpu() if hasattr(want, "cpu") else want).astype(np.int32)
    d = np.abs(got - want)
    return int(d.max()), float((d != 0).mean())
