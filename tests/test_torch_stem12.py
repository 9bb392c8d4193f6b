"""The stem12 launch's plain version and route (`embodied_clip_tpu_torch/ops/kernels/
stem_kernel.py:stem12_f32`, `ops/quantize.py:_stem`) on the CPU, where the wrapper takes
its plain version:
  - `stem12_f32_reference` is the int8 graph's stem1 → stem2 → bf16 route through
    `ops/quantize._fp_conv`, bit for bit, at every stem width the launch takes, on bf16
    and f32 frames;
  - `stem12_weights` holds the bf16-rounded kernels in the rows the launch reads;
  - the frames the wrapper copies into the launch's form (`_stem12_frames`: half
    precision, strided, misaligned, odd H or W) give the plain version's result, bit for
    bit;
  - `_stem` takes the launch under `kernel_stem` with the default stem of a width K2
    takes, on any frames, and K2 where stem2's output has even H and W; the int8 stems,
    the plain graph and the torchvision graph keep `_fp_conv`, and where the launch is
    taken the stem's s8 output is the old route's, bit for bit.

The kernel itself runs only on a card: `tests/test_torch_gpu.py::
test_stem12_kernel_matches_plain_version`.
"""

import numpy as np
import pytest
import torch

from embodied_clip_tpu_torch.models.clip_resnet import ModifiedResNet
from embodied_clip_tpu_torch.models.resnet import RESNET_CONFIGS, ResNet
from embodied_clip_tpu_torch.ops import quantize as Q
from embodied_clip_tpu_torch.ops.fold_bn import fold_conv_bn_state_dict
from embodied_clip_tpu_torch.ops.kernels import stem_kernel as SK


def _stem_q(c: int, rng) -> dict:
    return {"fp": {
        "stem1": {"kernel": torch.from_numpy(rng.randn(3, 3, 3, c).astype(np.float32) * 0.3),
                  "bias": torch.from_numpy(rng.randn(c).astype(np.float32) * 0.1)},
        "stem2": {"kernel": torch.from_numpy(rng.randn(3, 3, c, c).astype(np.float32)
                                             / np.sqrt(9 * c)),
                  "bias": torch.from_numpy(rng.randn(c).astype(np.float32) * 0.1)}}}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16)


@pytest.mark.parametrize("c", SK.STEM12_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stem12_plain_version_is_the_fp_conv_chain(c, dtype):
    """The plain version equals `_fp_conv(stem1)` → `_fp_conv(stem2)` → `.to(bf16)`, the
    route the int8 graph ran before the launch, on every bit (20 × 28 frames, batch 2)."""
    rng = np.random.RandomState(c)
    q = _stem_q(c, rng)
    x = torch.from_numpy(rng.randn(2, 20, 28, 3).astype(np.float32)).to(dtype)
    want = Q._fp_conv(q, "stem2", Q._fp_conv(q, "stem1", x, 2)).to(torch.bfloat16)
    s1, s2 = q["fp"]["stem1"], q["fp"]["stem2"]
    got = SK.stem12_f32(x, s1["kernel"], s1["bias"], s2["kernel"], s2["bias"])
    assert got.shape == (2, 10, 14, c) and got.dtype == torch.bfloat16
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(SK.stem12_f32_reference(x, s1["kernel"], s1["bias"],
                                                     s2["kernel"], s2["bias"])), _bits(want))
    assert 0.2 < float((want.float() > 0).float().mean()) < 0.8


def test_stem12_weights_are_the_kernels_operands():
    """w1 row (ky·3 + kx)·3 + ci and w2 row (ky·3 + kx)·C + ci hold the bf16-rounded
    kernels' column co, as f32; the biases are f32."""
    rng = np.random.RandomState(7)
    q = _stem_q(8, rng)
    s1, s2 = q["fp"]["stem1"], q["fp"]["stem2"]
    ops = SK.stem12_weights(s1["kernel"], s1["bias"], s2["kernel"], s2["bias"])
    assert {k: tuple(v.shape) for k, v in ops.items()} == {
        "w1": (27, 8), "b1": (8,), "w2": (72, 8), "b2": (8,)}
    assert all(v.dtype == torch.float32 and v.is_contiguous() for v in ops.values())
    k1 = s1["kernel"].to(torch.bfloat16).float()
    k2 = s2["kernel"].to(torch.bfloat16).float()
    for ky, kx, ci, co in ((0, 0, 0, 0), (1, 2, 2, 5), (2, 1, 1, 7)):
        assert ops["w1"][(ky * 3 + kx) * 3 + ci, co] == k1[ky, kx, ci, co]
    for ky, kx, ci, co in ((0, 0, 0, 0), (1, 2, 6, 5), (2, 2, 7, 3)):
        assert ops["w2"][(ky * 3 + kx) * 8 + ci, co] == k2[ky, kx, ci, co]
    assert torch.equal(ops["b2"], s2["bias"])


@pytest.fixture(scope="module")
def tiny_q():
    """A width-16 CLIP trunk (stem widths 8/8/16), folded and quantized on 64² frames."""
    torch.manual_seed(0)
    stage_sizes = (1, 1, 1, 1)
    sd = fold_conv_bn_state_dict(ModifiedResNet(stage_sizes, 16).state_dict())
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 64, 64, 3).astype(np.float32))
    return Q.quantize_trunk(sd, stage_sizes, x)


def _count_routes(monkeypatch):
    """Patch the stem12 wrapper and `_fp_conv` to record their calls: {"stem12": n,
    "fp_conv": [stem conv names]}, leaving out the `_fp_conv` calls of stem12's plain
    version, which the wrapper takes on the CPU."""
    seen = {"stem12": 0, "fp_conv": []}
    inside = []
    stem12, fp_conv = SK.stem12_f32, Q._fp_conv

    def counting_stem12(*a, **k):
        seen["stem12"] += 1
        inside.append(True)
        try:
            return stem12(*a, **k)
        finally:
            inside.pop()

    def counting_fp_conv(q, name, *a, **k):
        if name.startswith("stem") and not inside:
            seen["fp_conv"].append(name)
        return fp_conv(q, name, *a, **k)

    monkeypatch.setattr(SK, "stem12_f32", counting_stem12)
    monkeypatch.setattr(Q, "_fp_conv", counting_fp_conv)
    return seen


# (switches, int8_stem, frame shape, dtype, whether stem12 runs, the stem convs left to
# `_fp_conv`): paths A and B and `kernel_stem` alone take it on any frames, and K2 after
# it where stem2's output has even H and W (else the plain stem3 conv); the int8 stems
# and the plain graph do not.
ROUTES = [
    ("A", "off", (2, 64, 64, 3), torch.float32, 1, []),
    ("A", "off", (2, 64, 64, 3), torch.bfloat16, 1, []),
    ("B", "off", (1, 48, 32, 3), torch.float32, 1, []),
    ("stem only", "off", (2, 64, 64, 3), torch.float32, 1, []),
    ("A", "stem3", (2, 64, 64, 3), torch.float32, 0, ["stem1", "stem2"]),
    ("A", "full", (2, 64, 64, 3), torch.float32, 0, ["stem1"]),
    ("off", "off", (2, 64, 64, 3), torch.float32, 0, ["stem1", "stem2", "stem3"]),
    ("A", "off", (2, 66, 64, 3), torch.float32, 1, ["stem3"]),
    ("A", "off", (2, 64, 62, 3), torch.float32, 1, ["stem3"]),
    ("A", "off", (1, 63, 63, 3), torch.float32, 1, []),
    ("A", "off", (2, 64, 64, 3), torch.float16, 1, []),
]
SWITCHES = {"A": Q.PATH_A, "B": Q.PATH_B, "off": Q.KERNELS_OFF,
            "stem only": {**Q.KERNELS_OFF, "kernel_stem": True}}


def _old_stem(q, x, s_in):
    """The default stem's s8 output on the route before stem12: `_fp_conv` stem1 → stem2,
    then K2's plain version on the bf16 output where its H and W are even, else the plain
    stem3 conv."""
    t = Q._fp_conv(q, "stem2", Q._fp_conv(q, "stem1", x, 2))
    if t.shape[1] % 2 or t.shape[2] % 2:
        return Q.avg_pool_int8(Q.requant(Q._fp_conv(q, "stem3", t, relu=False), s_in), 2)
    sub = q["fp"]["stem3"]
    return SK.stem3_requant_pool_int8_reference(t.to(torch.bfloat16), sub["kernel"],
                                                sub["bias"], s_in)


@pytest.mark.parametrize("path,int8_stem,shape,dtype,stem12,fp_convs", ROUTES)
def test_stem_takes_stem12_only_under_its_gate(tiny_q, monkeypatch, path, int8_stem, shape,
                                               dtype, stem12, fp_convs):
    """`_stem`'s route; where stem12 runs, the stem's s8 output is the old route's
    (`_fp_conv` stem1 → stem2 → bf16 → K2's plain version), bit for bit."""
    x = torch.from_numpy(np.random.RandomState(1).randn(*shape).astype(np.float32)).to(dtype)
    s_in = tiny_q["act_scales"]["stem.out"]
    sw = SWITCHES[path]
    seen = _count_routes(monkeypatch)
    got = Q._stem(tiny_q, x, s_in, sw["kernel_stem"], int8_stem, False,
                  sw["kernel_stride_blocks"])
    assert seen == {"stem12": stem12, "fp_conv": fp_convs}
    if stem12:
        assert got.dtype == torch.int8 and torch.equal(got, _old_stem(tiny_q, x, s_in))


def test_stem_takes_stem12_for_frames_not_contiguous(tiny_q, monkeypatch):
    """A strided frame batch takes stem12 too (the wrapper copies it into the launch's
    form on the card), with the old route's s8 output and its contiguous copy's."""
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 64, 128, 3).astype(np.float32))
    x = x.to(torch.bfloat16)[:, :, ::2]
    s_in = tiny_q["act_scales"]["stem.out"]
    seen = _count_routes(monkeypatch)
    got = Q._stem(tiny_q, x, s_in, True, "off", False)
    assert seen == {"stem12": 1, "fp_conv": []}
    assert torch.equal(got, _old_stem(tiny_q, x, s_in))
    assert torch.equal(got, Q._stem(tiny_q, x.contiguous(), s_in, True, "off", False))


def _odd_frames(kind: str) -> torch.Tensor:
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 22, 30, 3).astype(np.float32))
    return {"float16": x.to(torch.float16), "float64": x.double(),
            "strided": x.to(torch.bfloat16)[:, ::2, 1::2],
            "offset bf16": x.to(torch.bfloat16).flatten()[1:1 + 2 * 20 * 30 * 3].view(
                2, 20, 30, 3),
            "odd H": x[:, :21], "odd W": x[:, :, :29], "odd both": x[:, 1:, 1:]}[kind]


@pytest.mark.parametrize("kind", ["float16", "float64", "strided", "offset bf16", "odd H",
                                  "odd W", "odd both"])
def test_stem12_frames_keep_the_plain_result(kind):
    """`_stem12_frames` copies frames into the form the launch reads (contiguous, 4-byte
    aligned bf16 or f32, even H and W) and the plain version gives the same bits on the
    copy as on the frames: the cast is `_fp_conv`'s own, and an odd H or W gains the zero
    row or column that stem1's stride-2 taps read as padding there."""
    x = _odd_frames(kind)
    y = SK._stem12_frames(x)
    assert y.dtype in (torch.bfloat16, torch.float32) and y.is_contiguous()
    assert y.data_ptr() % 4 == 0 and y.shape[1] % 2 == 0 and y.shape[2] % 2 == 0
    assert y.shape[1] - x.shape[1] == x.shape[1] % 2 and y.shape[2] - x.shape[2] == x.shape[2] % 2
    s1, s2 = _stem_q(8, np.random.RandomState(2))["fp"].values()
    args = (s1["kernel"], s1["bias"], s2["kernel"], s2["bias"])
    want = SK.stem12_f32_reference(x, *args)
    assert want.shape[1:3] == ((x.shape[1] + 1) // 2, (x.shape[2] + 1) // 2)
    assert torch.equal(_bits(SK.stem12_f32_reference(y, *args)), _bits(want))


def test_trunk_paths_take_stem12_and_keep_their_output(tiny_q, monkeypatch):
    """`quantized_trunk_apply` on paths A and B calls stem12 once an encode and the plain
    graph never; the trunk's output on path A is the same with the launch's route and with
    the gate patched shut (`_fp_conv`'s stem)."""
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32))
    seen = _count_routes(monkeypatch)
    outs = {}
    for path in ("A", "B", "off"):
        before = seen["stem12"]
        outs[path] = Q.quantized_trunk_apply(tiny_q, x, (1, 1, 1, 1), torch.float32,
                                             **SWITCHES[path])
        assert seen["stem12"] - before == (0 if path == "off" else 1)
    monkeypatch.setattr(Q, "_stem12_takes", lambda q: False)
    old = Q.quantized_trunk_apply(tiny_q, x, (1, 1, 1, 1), torch.float32, **Q.PATH_A)
    assert torch.equal(outs["A"], old)


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_torchvision_graph_keeps_fp_conv(monkeypatch, name):
    """The torchvision int8 graph's 7×7 stem and `down` convs stay on `_fp_conv`: it never
    reaches stem12."""
    torch.manual_seed(1)
    cfg = RESNET_CONFIGS[name]
    sd = fold_conv_bn_state_dict(ResNet(width=8, **cfg).state_dict())
    x = torch.from_numpy(np.random.RandomState(3).randn(1, 64, 64, 3).astype(np.float32))
    q = Q.quantize_resnet_trunk(sd, cfg["stage_sizes"], cfg["block"], x)
    seen = _count_routes(monkeypatch)
    Q.quantized_resnet_apply(q, x, cfg["stage_sizes"], cfg["block"])
    assert seen == {"stem12": 0, "fp_conv": ["stem"]}
