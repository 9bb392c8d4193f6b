"""The port's CUDA kernels (K1–K7) on the card, each held to its plain PyTorch
version at small shapes and at the main path's widths, with the JAX package's contracts
(K6/K7: `parity.bf16_disagreement`).

Marked `gpu`: each test skips where no CUDA device is present (decided inside the
test). This file imports no JAX, so it runs on a machine without it:

    python -m pytest tests/test_torch_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from embodied_clip_tpu_torch import constants
from embodied_clip_tpu_torch.models.clip_resnet import ModifiedResNet
from embodied_clip_tpu_torch.models.encoders import build_encoder
from embodied_clip_tpu_torch.ops import quantize as Q
from embodied_clip_tpu_torch.ops.fold_bn import fold_conv_bn_state_dict
from embodied_clip_tpu_torch.ops.int8 import qmm, requant
from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
from embodied_clip_tpu_torch.ops.kernels import preprocess_kernel as K
from embodied_clip_tpu_torch.ops.kernels import stem_kernel as SK
from embodied_clip_tpu_torch.parity import (
    BF16_KERNEL_SHARE,
    bf16_disagreement,
    cosine_distance,
    golden_frames,
    stage1_block_disagreements,
)

import torch_int8_cases as C

pytestmark = pytest.mark.gpu
MEAN, STD = constants.CLIP_MEAN, constants.CLIP_STD


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    return torch.device("cuda")


@pytest.mark.parametrize("n,in_hw,size", [(8, (300, 300), 224), (3, (160, 120), 224),
                                          (2, (301, 299), 224), (2, (480, 640), 384)])
def test_fused_preprocess_kernel_matches_plain_version(cuda, n, in_hw, size):
    frames = np.random.RandomState(0).randint(0, 256, (n, *in_hw, 3), np.uint8)
    x = torch.from_numpy(frames).to(cuda)
    before = K.fused_preprocess.launches
    got = K.fused_preprocess(x, size, MEAN, STD, dtype=torch.float32)
    got_bf16 = K.fused_preprocess(x, size, MEAN, STD, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert K.fused_preprocess.launches == before + 2
    ref = K.fused_preprocess_reference(x, size, MEAN, STD, dtype=torch.float32)
    lsb = 1.0 / 255.0 / min(STD)
    err = (got - ref).abs()
    assert float(err.max()) <= 1.5 * lsb
    assert float((err > 0.5 * lsb).float().mean()) < 1e-3
    assert torch.equal(got_bf16, got.to(torch.bfloat16))


def _t(a, dev, dtype=None):
    return torch.from_numpy(np.asarray(a)).to(dev, dtype)


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 16, 16, 32, 64), (3, 112, 112, 32, 64),
                                            (1, 192, 192, 48, 96)])
def test_stem3_kernel_matches_plain_version(cuda, n, h, w, cin, cout):
    """K2 vs its plain version: ≤1 s8 step on ≤0.5% of elements (the f32 sum order)."""
    rng = np.random.RandomState(0)
    x = _t(np.abs(rng.randn(n, h, w, cin)).astype(np.float32) * 0.5, cuda, torch.bfloat16)
    kernel = _t(rng.randn(3, 3, cin, cout).astype(np.float32) * 0.1, cuda)
    bias = _t(rng.randn(cout).astype(np.float32) * 0.05, cuda)
    scale = torch.tensor(2.3 / 127, device=cuda)
    before = SK.stem3_requant_pool_int8.launches
    got = SK.stem3_requant_pool_int8(x, kernel, bias, scale)
    torch.cuda.synchronize()
    assert SK.stem3_requant_pool_int8.launches == before + 1
    want = SK.stem3_requant_pool_int8_reference(x, kernel, bias, scale)
    assert got.shape == want.shape == (n, h // 2, w // 2, cout)
    dmax, frac = C.step_diff(got, want)
    assert dmax <= 1 and frac <= 0.005, (dmax, frac)


@pytest.mark.parametrize("n,h", [(2, 14), (2, 56)])
def test_stage1_kernel_matches_plain_version(cuda, n, h):
    """K3 vs its plain version, RN50-shaped stage 1: ≤1 step on ≤0.5% of elements."""
    rng = np.random.RandomState(0)
    ops = Q.stage1_int8_operands(C.to_torch(C.stage1_q(rng), cuda))
    x8 = _t(C.s8(rng, (n, h, h, 64)), cuda)
    before = BK.fused_stage1_int8.launches
    got = BK.fused_stage1_int8(x8, ops)
    torch.cuda.synchronize()
    assert BK.fused_stage1_int8.launches == before + 1
    want = BK.fused_stage1_int8_reference(x8, ops)
    assert got.shape == want.shape == (n, h, h, 256)
    dmax, frac = C.step_diff(got, want)
    assert dmax <= 1 and frac <= 0.005, (dmax, frac)


@pytest.mark.parametrize("cin,cm,n,h", [(256, 64, 2, 7), (1280, 320, 2, 14),
                                        (512, 128, 64, 28), (2048, 512, 8, 7)])
def test_cb3_cb1_kernel_matches_plain_version(cuda, cin, cm, n, h):
    """K4 vs its plain version, bit-exact (K = C > 1024 included)."""
    rng = np.random.RandomState(1)
    q, names = C.identity_q(rng, cin, cm, 2)
    q = C.to_torch(q, cuda)
    ops = Q.cb3_cb1_operands(q, names[0], names[1], torch.tensor(1.9 / 127, device=cuda))
    x8 = _t(C.s8(rng, (n, h, h, cm)), cuda)
    res8 = _t(C.s8(rng, (n, h, h, cin)), cuda)
    before = BK.fused_cb3_cb1_int8.launches
    out8, y8 = BK.fused_cb3_cb1_int8(x8, res8, ops)
    torch.cuda.synchronize()
    assert BK.fused_cb3_cb1_int8.launches == before + 1
    ref8, refy = BK.fused_cb3_cb1_int8_reference(x8, res8, ops)
    assert torch.equal(out8, ref8) and torch.equal(y8, refy)


@pytest.mark.parametrize("cin,cm,nb,n,h,out_dtype", [
    (32, 16, 3, 2, 6, torch.int8), (32, 16, 3, 2, 6, torch.bfloat16),
    (32, 16, 2, 2, 6, torch.float32), (512, 128, 3, 4, 28, torch.int8),
    (2048, 512, 2, 2, 7, torch.bfloat16)])
def test_resblocks_kernel_matches_plain_version(cuda, cin, cm, nb, n, h, out_dtype):
    """K5 vs its plain version, bit-exact, s8 and conv-map (bf16/f32) outputs."""
    rng = np.random.RandomState(2)
    q, names = C.identity_q(rng, cin, cm, nb)
    q = C.to_torch(q, cuda)
    s_next = (q["act_scales"][f"{names[-1]}.out"] if out_dtype == torch.int8
              else torch.ones((), device=cuda))
    ops, scl = Q.resblocks_int8_operands(q, names, torch.tensor(1.8 / 127, device=cuda),
                                         s_next)
    x8 = _t(C.s8(rng, (n, h, h, cin)), cuda)
    before = BK.fused_resblocks_int8.launches
    got = BK.fused_resblocks_int8(x8, ops, scl, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert BK.fused_resblocks_int8.launches == before + 1
    want = BK.fused_resblocks_int8_reference(x8, ops, scl, out_dtype=out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)


def test_int8_trunk_paths_on_the_card(cuda, monkeypatch):
    """A width-16 trunk with stage sizes (3, 2, 2, 2), quantized on the card: path A
    (K2, K3, K5 with the gate lowered) and path B (K2, K3, K4) are bit-identical, and
    both stay within 1e-3 cosine of the plain graph (K2 skips the graph's bf16
    rounding of the stem3 conv)."""
    monkeypatch.setattr(Q, "PALLAS_RESBLOCKS_MIN_CM", 1)
    torch.manual_seed(0)
    stage_sizes = (3, 2, 2, 2)
    sd = fold_conv_bn_state_dict(ModifiedResNet(stage_sizes, 16).state_dict())
    sd = {k: v.to(cuda) for k, v in sd.items()}
    x = _t(np.random.RandomState(5).randn(2, 64, 64, 3).astype(np.float32), cuda)
    q = Q.quantize_trunk(sd, stage_sizes, x)
    counted = (SK.stem3_requant_pool_int8, BK.fused_stage1_int8,
               BK.fused_resblocks_int8, BK.fused_cb3_cb1_int8)
    outs, launches = {}, {}
    for path, switches in (("A", Q.PATH_A), ("B", Q.PATH_B), ("off", Q.KERNELS_OFF)):
        before = [f.launches for f in counted]
        outs[path] = Q.quantized_trunk_apply(q, x, stage_sizes, torch.float32, **switches)
        torch.cuda.synchronize()
        launches[path] = [f.launches - b for f, b in zip(counted, before)]
    assert launches == {"A": [1, 1, 3, 0], "B": [1, 1, 0, 5], "off": [0, 0, 0, 0]}
    assert torch.equal(outs["A"], outs["B"])
    assert bool(torch.isfinite(outs["A"]).all()) and outs["A"].shape == (2, 2, 2, 512)
    assert cosine_distance(outs["A"], outs["off"]) <= 1e-3


def test_int8_epilogue_divides_on_the_card(cuda):
    """The plain graph's requant on CUDA divides by the device scale (IEEE, as the
    kernels' __fdiv_rn): bit-equal to the CPU's, near-ties included."""
    rng = np.random.RandomState(3)
    v = rng.randn(1 << 20).astype(np.float32) * 300
    v[: 1 << 10] = (np.arange(1 << 10, dtype=np.float32) + 0.5) * np.float32(0.0137)
    r = torch.tensor(0.0137)
    assert torch.equal(requant(_t(v, cuda), r.to(cuda)).cpu(), requant(torch.from_numpy(v), r))
    a = torch.from_numpy(C.s8(rng, (5, 12), 127))
    b = torch.from_numpy(C.s8(rng, (12, 6), 127))
    assert torch.equal(qmm(a.to(cuda), b.to(cuda)).cpu(), a.int() @ b.int())


def test_int8_kernels_reject_what_they_cannot_take(cuda):
    rng = np.random.RandomState(4)
    q, names = C.identity_q(rng, 32, 16, 2)
    q = C.to_torch(q, cuda)
    ops = Q.cb3_cb1_operands(q, names[0], names[1], torch.tensor(0.01, device=cuda))
    x8 = _t(C.s8(rng, (2, 6, 6, 16)), cuda)
    with pytest.raises(ValueError, match="int8"):
        BK.fused_cb3_cb1_int8(x8, torch.zeros((2, 6, 6, 32), device=cuda), ops)
    with pytest.raises(ValueError, match="chain"):
        BK.fused_cb3_cb1_int8(x8, x8, ops)
    x = torch.zeros((1, 15, 16, 32), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="even"):
        SK.stem3_requant_pool_int8(x, torch.zeros((3, 3, 32, 64), device=cuda),
                                   torch.zeros(64, device=cuda), 0.01)


def test_fused_preprocess_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.from_numpy(golden_frames(2)).to(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_preprocess(x[:, :, ::2], 224, MEAN, STD)
    with pytest.raises(ValueError, match="uint8"):
        K.fused_preprocess(x.float(), 224, MEAN, STD)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        K.fused_preprocess(x, 224, MEAN, STD, dtype=torch.float16)


def _bf16_block(rng, c_in, cm, c_out, dev):
    """A folded bottleneck's weights, scaled so activations stay O(1): bf16 weights in
    the JAX layout, f32 biases."""
    def w(*shape, fan):
        return _t(rng.randn(*shape).astype(np.float32) / np.sqrt(fan), dev, torch.bfloat16)

    def b(c):
        return _t(rng.randn(c).astype(np.float32) * 0.1, dev)

    return {"w1": w(c_in, cm, fan=c_in), "b1": b(cm), "w2": w(3, 3, cm, cm, fan=9 * cm),
            "b2": b(cm), "w3": w(cm, c_out, fan=2 * cm), "b3": b(c_out)}


def _assert_bf16_contract(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    share, worst = bf16_disagreement(got, want)
    print(f"bf16 kernel vs plain on {tuple(got.shape)}: {share:.2e} of elements differ, "
          f"worst {worst:.3f} of the allowance")
    assert share <= BF16_KERNEL_SHARE and worst <= 1.0, (share, worst)


# (n, h, c, cm): test width (Cm 8), RN50 stages 2-4, RN50x16 stages 3-4.
@pytest.mark.parametrize("n,h,c,cm", [(2, 6, 32, 8), (2, 10, 64, 16), (4, 28, 512, 128),
                                      (4, 14, 1024, 256), (16, 7, 2048, 512),
                                      (2, 24, 1536, 384), (2, 12, 3072, 768)])
def test_fused_bottleneck_kernel_matches_plain_version(cuda, n, h, c, cm):
    """K6 vs its plain version (bf16, f32 accumulation): the card contract."""
    rng = np.random.RandomState(6)
    blk = _bf16_block(rng, c, cm, c, cuda)
    x = _t(np.abs(rng.randn(n, h, h, c)).astype(np.float32), cuda, torch.bfloat16)
    args = (x, blk["w1"], blk["b1"], blk["w2"], blk["b2"], blk["w3"], blk["b3"])
    before = BK.fused_bottleneck.launches
    got = BK.fused_bottleneck(*args)
    torch.cuda.synchronize()
    assert BK.fused_bottleneck.launches == before + 1
    _assert_bf16_contract(got, BK.fused_bottleneck_reference(*args))


# (n, h, cin, cm, cout, blocks): RN50 stage 1, RN50x16 stage 1, clip_rn_tiny's 1 block.
@pytest.mark.parametrize("n,h,cin,cm,cout,nb", [(2, 56, 64, 64, 256, 3),
                                                (1, 96, 96, 96, 384, 3),
                                                (2, 8, 8, 8, 32, 1)])
def test_fused_stage1_kernel_matches_plain_version(cuda, n, h, cin, cm, cout, nb):
    """K7 vs its plain version (bf16, f32 accumulation): the card contract block by
    block (`parity.stage1_block_disagreements`); the chained output is reported."""
    rng = np.random.RandomState(7)
    blocks = [_bf16_block(rng, cin if i == 0 else cout, cm, cout, cuda) for i in range(nb)]
    shortcut = (_t(rng.randn(cin, cout).astype(np.float32) / np.sqrt(cin), cuda,
                   torch.bfloat16), _t(rng.randn(cout).astype(np.float32) * 0.1, cuda))
    x = _t(np.abs(rng.randn(n, h, h, cin)).astype(np.float32), cuda, torch.bfloat16)
    before = BK.fused_stage1.launches
    got = BK.fused_stage1(x, blocks, shortcut)
    torch.cuda.synchronize()
    assert BK.fused_stage1.launches == before + 1
    assert got.shape == (n, h, h, cout)
    want = BK.fused_stage1_reference(x, blocks, shortcut)
    share, worst = bf16_disagreement(got, want)
    print(f"K7 chained on {tuple(got.shape)}: {share:.2e} differ, worst {worst:.3f}")
    assert bool(torch.isfinite(got.float()).all())
    per_block = stage1_block_disagreements(x, blocks, shortcut)
    print(f"K7 per block (share, worst): {per_block}")
    assert all(s <= BF16_KERNEL_SHARE and w <= 1.0 for s, w in per_block), per_block


def test_bf16_kernels_reject_what_they_cannot_take(cuda):
    rng = np.random.RandomState(8)
    blk = _bf16_block(rng, 32, 8, 32, cuda)
    w = (blk["w1"], blk["b1"], blk["w2"], blk["b2"], blk["w3"], blk["b3"])
    x = torch.ones((2, 6, 6, 32), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        BK.fused_bottleneck(x.float(), *w)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        BK.fused_bottleneck(x.permute(0, 2, 1, 3), *w)
    with pytest.raises(ValueError, match="multiple of 8"):
        BK.fused_bottleneck(x[..., :28].contiguous(), *w)
    narrow = _bf16_block(rng, 32, 4, 32, cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        BK.fused_bottleneck(x, *(narrow[k] for k in ("w1", "b1", "w2", "b2", "w3", "b3")))
    with pytest.raises(ValueError, match="bfloat16"):
        BK.fused_bottleneck(x, blk["w1"].float(), *w[1:])
    with pytest.raises(ValueError, match="bfloat16"):
        BK.fused_stage1(x.float(), [blk], (blk["w1"], blk["b1"]))


@pytest.mark.parametrize("name,k7,k6", [("clip_rn50", 1, 10), ("imagenet_rn50", 1, 10),
                                        ("imagenet_rn18", 0, 0)])
def test_bf16_folded_encoder_launch_counts(cuda, name, k7, k6):
    """One request through a folded bf16 encoder launches K1 once, K7 once per
    bottleneck stage 1 and K6 once per stride-1 identity bottleneck; its cuDNN route
    (`fold_bn(fused_bottlenecks=False)`) launches neither."""
    base = build_encoder(name, dtype=torch.bfloat16)
    counted = (K.fused_preprocess, BK.fused_stage1, BK.fused_bottleneck)
    for enc, want in ((base.fold_bn(), [1, k7, k6]),
                      (base.fold_bn(fused_bottlenecks=False), [1, 0, 0])):
        before = [f.launches for f in counted]
        out = enc.encode(golden_frames(2))
        torch.cuda.synchronize()
        assert [f.launches - b for f, b in zip(counted, before)] == want
        assert all(v.dtype == torch.bfloat16 and bool(torch.isfinite(v.float()).all())
                   for v in out.values())
