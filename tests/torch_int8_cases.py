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


def stride_q(rng, cin, cm, cout, name="layer2_0"):
    """One stride block (block 0 of a later stage) named `name`: cb1 (cin → cm), the 3×3
    cb2, cb3 (cm → cout), the conv shortcut (cin → cout, f32 HWIO as the quantizer keeps
    it) and their scales. Returns (q, the block input's scale s_in)."""
    q = {"act_scales": {}, "fp": {}}
    a = q["act_scales"]
    q[f"{name}/cb1"] = qk(rng, cin, cm)
    q[f"{name}/cb2"] = qk(rng, cm, cm, 3)
    q[f"{name}/cb3"] = qk(rng, cm, cout)
    a[f"{name}/cb2.in"] = np.float32(1.5 / 127)
    a[f"{name}/cb3.in"] = np.float32(1.2 / 127)
    a[f"{name}/down.out"] = np.float32(1.7 / 127)
    a[f"{name}.out"] = np.float32(2.1 / 127)
    q["fp"][f"{name}/down"] = {"conv": {
        "kernel": (rng.randn(1, 1, cin, cout) / np.sqrt(cin)).astype(np.float32),
        "bias": (rng.randn(cout) * 0.05).astype(np.float32)}}
    return q, np.float32(2.0 / 127)


# The scale of the planted requants: x / R and x · (1 / R) part on 118 of the 127
# boundaries n + 0.5 that a requant meets (fl(1 / R) lies below 1 / R by nearly half its
# ulp), and every value the planted trunks form before a requant is exact in f32.
PLANT_SCALE = np.float32(61 * 2.0 ** -14)


def _planted(ci, co, k=1, w_scale=1.0):
    """A one-hot s8 conv: output channel j reads input channel j % ci at the centre tap,
    with bias R / 2."""
    q = np.zeros((k, k, ci, co), np.int8)
    q[k // 2, k // 2, np.arange(co) % ci, np.arange(co)] = 1
    return {"kernel_q": q, "w_scale": np.full(co, w_scale, np.float32),
            "bias": np.full(co, PLANT_SCALE / 2, np.float32)}


def _planted_blocks(names, cin, cm, cout):
    q = {"act_scales": {}, "fp": {}}
    for i, nm in enumerate(names):
        q[f"{nm}/cb1"] = _planted(cin if i == 0 else cout, cm)
        q[f"{nm}/cb2"], q[f"{nm}/cb3"] = _planted(cm, cm, 3), _planted(cm, cout)
        for key in ("/cb2.in", "/cb3.in", ".out"):
            q["act_scales"][nm + key] = PLANT_SCALE
    return q


def planted_identity_q(cin, cm, nb, prefix="layer3"):
    """identity_q's layout with every requant planted on a boundary: one-hot kernels,
    w_scale 1, biases R / 2 and every activation scale R = PLANT_SCALE. Each requant's
    quotient is then exactly n + 0.5 for an integer n: the division gives n + 1, the
    reciprocal form n on most n. Inputs below 12 keep three blocks under the clip."""
    names = [f"{prefix}_{i}" for i in range(1, nb + 1)]
    return _planted_blocks(names, cin, cm, cin), names


def planted_stage1_q(cin=64, cm=64, cout=256):
    """stage1_q's layout planted as `planted_identity_q`, its shortcut too: stem.out =
    2^-4 keeps bf16(x8 · s_in) exact, cb1a's w_scale 16R makes its epilogue scale R, and
    the shortcut is one-hot with weight 16R (exact in bf16) and bias R / 2 on the scale
    R, so that its one-term f32 sum is exact in any order."""
    q = _planted_blocks(["layer1_0", "layer1_1", "layer1_2"], cin, cm, cout)
    q["layer1_0/cb1"]["w_scale"][:] = 16 * PLANT_SCALE
    kernel = np.zeros((1, 1, cin, cout), np.float32)
    kernel[0, 0, np.arange(cout) % cin, np.arange(cout)] = 16 * PLANT_SCALE
    q["fp"]["layer1_0/down"] = {"conv": {
        "kernel": kernel, "bias": np.full(cout, PLANT_SCALE / 2, np.float32)}}
    q["act_scales"]["stem.out"] = np.float32(2.0 ** -4)
    q["act_scales"]["layer1_0/down.out"] = PLANT_SCALE
    return q


def planted_stride_q(cin, cm, cout, name="layer2_0"):
    """stride_q's layout planted as `planted_stage1_q`: one-hot convs and shortcut, every
    requant's quotient exactly n + 0.5 (s_in = 2^-4, cb1's w_scale 16R, the shortcut's
    weight 16R). Returns (q, s_in)."""
    q = _planted_blocks([name], cin, cm, cout)
    q[f"{name}/cb1"]["w_scale"][:] = 16 * PLANT_SCALE
    kernel = np.zeros((1, 1, cin, cout), np.float32)
    kernel[0, 0, np.arange(cout) % cin, np.arange(cout)] = 16 * PLANT_SCALE
    q["fp"][f"{name}/down"] = {"conv": {
        "kernel": kernel, "bias": np.full(cout, PLANT_SCALE / 2, np.float32)}}
    q["act_scales"][f"{name}/down.out"] = PLANT_SCALE
    return q, np.float32(2.0 ** -4)


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


def bf16_rounded_conv(q, name, t, stride=1, relu=True, f32_pointwise=False):
    """A stem or `down` conv of the port's int8 graphs with its output rounded to bf16,
    as a conv of bf16 operands gives it where XLA does not elide the rounding: the form
    those convs took before they followed XLA (tests/test_torch_stem_settle.py,
    test_torch_resnet_stem_settle.py, chip_smoke.py phase 14 (d)). It takes
    `ops/quantize._fp_conv`'s arguments so that it can stand in for it in the
    torchvision graph, which passes `f32_pointwise` False."""
    from embodied_clip_tpu_torch.ops.quantize import _nhwc_conv

    sub = q["fp"][name]
    k = sub["kernel"].to(torch.bfloat16).permute(3, 2, 0, 1)
    out = _nhwc_conv(t.to(torch.bfloat16), k, stride).float() + sub["bias"]
    return torch.relu(out) if relu else out


def s8(rng, shape, hi=90):
    return rng.randint(0, hi, shape).astype(np.int8)


def step_diff(got, want):
    """(max |diff|, share of elements that differ) of two integer arrays/tensors."""
    got = np.asarray(got.cpu() if hasattr(got, "cpu") else got).astype(np.int32)
    want = np.asarray(want.cpu() if hasattr(want, "cpu") else want).astype(np.int32)
    d = np.abs(got - want)
    return int(d.max()), float((d != 0).mean())



def shortcut_tie_elements(n_words: int, n: int):
    """The (row, column) of every bit of the stride shortcut's (e) flag words for an
    output of width n, as its flush decodes them (`csrc/bottleneck_int8.cu`): arrays of
    shape (n_words, 64). Word w is thread w % 256 of tile w // 256 (tiles row-major over
    128-column tiles); bit 4j + 2h + e of thread t is row 64·(t / 128) + 16·(t % 128 / 32)
    + (t % 32) / 4 + 8h and column 2·(t % 4) + 8j + e of its tile."""
    n_tiles = -(-n // 128)
    tile, t = np.divmod(np.arange(n_words), 256)
    lane = t % 32
    r0 = (tile // n_tiles) * 128 + 64 * (t // 128) + 16 * (t % 128 // 32) + lane // 4
    c0 = (tile % n_tiles) * 128 + 2 * (lane % 4)
    b = np.arange(64)
    return r0[:, None] + 8 * ((b >> 1) & 1), c0[:, None] + 8 * (b >> 2) + (b & 1)


def plain_near_ties(ties: torch.Tensor, m: int, n: int) -> int:
    """The set bits of (e)'s flag words on elements inside the (m, n) output, decoded
    bit by bit."""
    words = ties.cpu().numpy().view(np.uint64)
    rows, cols = shortcut_tie_elements(words.size, n)
    bits = (words[:, None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
    return int((bits.astype(bool) & (rows < m) & (cols < n)).sum())
