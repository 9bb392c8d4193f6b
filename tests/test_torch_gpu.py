"""The port's CUDA kernels (K1–K7) on the card, each held to its plain PyTorch
version at small shapes and at the main path's widths, with the JAX package's contracts
(K6/K7: `parity.bf16_disagreement`); the DD-PPO iteration and the host act steps with
the encoder on the card; a batch-8 `clip_rn50` extraction in bf16 and int8 against f32,
and a probe-trainer epoch on the card against the CPU.

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


def _frames_at(frames: np.ndarray, dev, offset: int) -> torch.Tensor:
    """The frames as a contiguous CUDA tensor whose data_ptr lies `offset` bytes past a
    256-byte-aligned allocation."""
    buf = torch.empty(offset + frames.size, dtype=torch.uint8, device=dev)
    x = buf[offset:].view(frames.shape)
    x.copy_(torch.from_numpy(frames))
    assert x.is_contiguous() and x.data_ptr() % 256 == offset
    return x


# (n, in_hw, size, offset): the main shape at batches 8, 1 and 5, an upscale, an odd
# width (897-byte rows), a 384-px output, and frames at data_ptr offsets 1, 3 and 13.
@pytest.mark.parametrize("n,in_hw,size,offset", [
    (8, (300, 300), 224, 0), (3, (160, 120), 224, 0), (2, (301, 299), 224, 0),
    (2, (480, 640), 384, 0), (1, (300, 300), 224, 0), (5, (300, 300), 224, 0),
    (3, (300, 300), 224, 13), (2, (301, 299), 224, 1), (1, (480, 640), 384, 3)])
def test_fused_preprocess_kernel_matches_plain_version(cuda, n, in_hw, size, offset):
    frames = np.random.RandomState(0).randint(0, 256, (n, *in_hw, 3), np.uint8)
    x = _frames_at(frames, cuda, offset)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_preprocess_kernel_is_bit_equal_at_the_main_shape(cuda, dtype):
    """At the main path's shape, (128, 300, 300) → 224, K1 computes its plain version's
    arithmetic (f32 taps, FMAs in tap order, the same q() and normalise): bit-equal."""
    x = torch.from_numpy(golden_frames(128)).to(cuda)
    got = K.fused_preprocess(x, 224, MEAN, STD, dtype=dtype)
    want = K.fused_preprocess_reference(x, 224, MEAN, STD, dtype=dtype)
    assert torch.equal(got, want)


def _t(a, dev, dtype=None):
    return torch.from_numpy(np.asarray(a)).to(dev, dtype)


# (n, h, w, cin, cout): small, RN50 (batch 3 and the main path's batch 128), a ragged
# width (W/2 = 18 pooled columns: no multiple of a tile), the width-16 trunk (Cin 8 →
# 16, zero-filled to one k16 step) and RN50x16 (48 → 96 at 192², in column spans).
@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 16, 16, 32, 64), (3, 112, 112, 32, 64),
                                            (1, 192, 192, 48, 96), (128, 112, 112, 32, 64),
                                            (3, 20, 36, 32, 64), (2, 16, 16, 8, 16),
                                            (2, 64, 64, 8, 16)])
def test_stem3_kernel_matches_plain_version(cuda, n, h, w, cin, cout):
    """K2 vs its plain version: ≤1 s8 step on ≤0.5% of elements (the f32 sum order); a
    second launch on the same input is bit-equal."""
    rng = np.random.RandomState(0)
    x = _t(np.abs(rng.randn(n, h, w, cin)).astype(np.float32) * 0.5, cuda, torch.bfloat16)
    kernel = _t(rng.randn(3, 3, cin, cout).astype(np.float32) * 0.1, cuda)
    bias = _t(rng.randn(cout).astype(np.float32) * 0.05, cuda)
    scale = torch.tensor(2.3 / 127, device=cuda)
    before = SK.stem3_requant_pool_int8.launches
    got = SK.stem3_requant_pool_int8(x, kernel, bias, scale)
    again = SK.stem3_requant_pool_int8(x, kernel, bias, scale,
                                       wmat=SK.stem3_weight_matrix(kernel))
    torch.cuda.synchronize()
    assert SK.stem3_requant_pool_int8.launches == before + 2
    want = SK.stem3_requant_pool_int8_reference(x, kernel, bias, scale)
    assert got.shape == want.shape == (n, h // 2, w // 2, cout)
    dmax, frac = C.step_diff(got, want)
    assert dmax <= 1 and frac <= 0.005, (dmax, frac)
    assert torch.equal(got, again)


@pytest.mark.parametrize("cin,cout", [(16, 64), (32, 32), (64, 64)])
def test_stem3_kernel_rejects_widths_it_cannot_take(cuda, cin, cout):
    """K2 takes Cin 8, 32 or 48 and Cout 16, 64 or 96; any other width raises, naming
    them, and is never computed some other way."""
    x = torch.zeros((1, 16, 16, cin), dtype=torch.bfloat16, device=cuda)
    before = SK.stem3_requant_pool_int8.launches
    with pytest.raises(ValueError, match="Cin"):
        SK.stem3_requant_pool_int8(x, torch.zeros((3, 3, cin, cout), device=cuda),
                                   torch.zeros(cout, device=cuda), 0.01)
    assert SK.stem3_requant_pool_int8.launches == before


# (n, h, cin, cm, cout): RN50's stage 1 (small, 56², and the main path's widths at batch
# 8), the width-16 trunk's stage 1 (16 → 64, Cm 16) and RN50x16's (96 → 384, Cm 96).
@pytest.mark.parametrize("n,h,cin,cm,cout", [(2, 14, 64, 64, 256), (2, 56, 64, 64, 256),
                                             (8, 56, 64, 64, 256), (2, 16, 16, 16, 64),
                                             (2, 24, 96, 96, 384)])
def test_stage1_kernel_matches_plain_version(cuda, n, h, cin, cm, cout):
    """K3 vs its plain version: ≤1 step on ≤0.5% of elements; seven launches (the entry
    launch, then 3 × (b), 2 × (c), (a)), counted once; a second call is bit-equal."""
    rng = np.random.RandomState(0)
    ops = Q.stage1_int8_operands(C.to_torch(C.stage1_q(rng, cin, cm, cout), cuda))
    x8 = _t(C.s8(rng, (n, h, h, cin)), cuda)
    before = BK.fused_stage1_int8.launches
    got = BK.fused_stage1_int8(x8, ops)
    again = BK.fused_stage1_int8(x8, ops)
    torch.cuda.synchronize()
    assert BK.fused_stage1_int8.launches == before + 2
    want = BK.fused_stage1_int8_reference(x8, ops)
    assert got.shape == want.shape == (n, h, h, cout)
    dmax, frac = C.step_diff(got, want)
    assert dmax <= 1 and frac <= 0.005, (dmax, frac)
    assert torch.equal(got, again)


def test_stage1_entry_launch_matches_its_parts(cuda):
    """K3's entry launch at RN50's widths: q1 bit-exact against cb1a's plain epilogue, the
    shortcut bit-equal to `_shortcut_reference` (its near-ties summed again exactly)."""
    rng = np.random.RandomState(6)
    ops = Q.stage1_int8_operands(C.to_torch(C.stage1_q(rng), cuda))
    x8 = _t(C.s8(rng, (4, 28, 28, 64)), cuda)
    scl = ops["scl"]
    q1, sc8, _ = BK._stage1_entry(x8, ops, BK._ptr(scl, 1), BK._ptr(scl, 0), BK._ptr(scl, 10))
    torch.cuda.synchronize()
    want_q1 = requant(BK._affine(BK._pw(x8, ops["k1a"]), ops["s1a"], ops["b1a"]), scl[1])
    assert torch.equal(q1, want_q1)
    want_sc = BK._shortcut_reference(x8, ops["wsc"], ops["bsc"], scl[0], scl[10])
    assert torch.equal(sc8, want_sc), C.step_diff(sc8, want_sc)


@pytest.mark.parametrize("cin,cout", sorted(BK.ENTRY_WIDTHS.items()))
def test_stage1_entry_shortcut_exact_on_planted_near_ties(cuda, cin, cout):
    """K3's shortcut where the tensor cores' sum order decides the requant: on 1/16 of
    the elements the exact sum puts sc / dsc on a requant boundary or 2^-20 … 2^-9 from
    one (offsets planned in f64, then moved by bsc's rounding to f32), the products
    summing to a fraction of Σ|x0·w| and bsc cancelling most of the sum. Every such
    element must come out as the plain version's: sc8 bit-equal. s_in = 2^-4 and dsc =
    2^-3 keep x0 exact; k = 0 carries t·dsc (wsc[0] = 2, x8[..., 0] = t), so that rows
    t = 0 … 99 of one base row sit near a boundary, t steps apart. At 704000 rows (2.08M
    at Cin 16, whose flag words hold 32 elements, a quarter of the words planted) a
    warpgroup flags more words than its list holds (4096), so the launch also sums
    near-ties again before its last tile."""
    rng = np.random.RandomState(7)
    nbase, steps = 16, 100
    s_in, dsc = 2.0 ** -4, 2.0 ** -3
    wsc = torch.from_numpy(rng.randn(cin, cout) * 2.0 ** -rng.randint(1, 13, (cin, cout)))
    wsc = wsc.to(torch.bfloat16)  # products 12 binades apart: f32 sums round
    wsc[0] = 2.0
    base = torch.from_numpy(rng.randint(40, 128, (nbase, cin))).to(torch.int8)
    x8 = base.repeat_interleave(steps, 0)
    x8[:, 0] = torch.arange(steps, dtype=torch.int8).repeat(nbase)
    # Column c is planted on base row c % nbase: v(t) = n + 0.5 + δ + t.
    x0 = base.double() * s_in
    x0[:, 0] = 0.0
    e_base = (x0 @ wsc.double())[torch.arange(cout) % nbase, torch.arange(cout)]
    deltas = torch.tensor([0.0] + [sg * 2.0 ** -e for e in (20, 17, 15, 12, 9) for sg in (1, -1)],
                          dtype=torch.float64)
    n = torch.from_numpy(rng.randint(-110, 11, cout)).double()
    v0 = n + 0.5 + deltas[torch.arange(cout) % len(deltas)]
    bsc = (v0 * dsc - e_base).float()
    reps = 440 if cin > 16 else 1300
    x8 = x8.reshape(nbase, steps, 1, cin).repeat(1, 1, reps, 1).to(cuda)
    rng2 = np.random.RandomState(8)
    ops = Q.stage1_int8_operands(C.to_torch(C.stage1_q(rng2, cin, cin, cout), cuda))
    ops["wsc"], ops["bsc"] = wsc.to(cuda).contiguous(), bsc.to(cuda)
    ops["scl"] = ops["scl"].clone()
    ops["scl"][0], ops["scl"][10] = s_in, dsc
    scl = ops["scl"]
    _, sc8, ties = BK._stage1_entry(x8, ops, BK._ptr(scl, 1), BK._ptr(scl, 0),
                                    BK._ptr(scl, 10))
    torch.cuda.synchronize()
    want = BK._shortcut_reference(x8, ops["wsc"], ops["bsc"], scl[0], scl[10])
    # Block 0 runs tiles 0, sms, 2·sms, …; its first warpgroup is consumer threads 0-127,
    # one flag word each per tile and pass.
    tiles = x8.numel() // cin // 128
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    words = ties.reshape(tiles, -1, 256)[::sms, :, :128]
    assert int((words != 0).sum()) > 4096
    # The plant worked: at least the planted share of quotients lies within 2^-8 of a
    # boundary.
    x0 = (x8.float() * scl[0]).to(torch.bfloat16).double()
    v = ((x0 @ wsc.to(cuda).double()).float() + ops["bsc"]) / scl[10]
    y = v.abs() - 0.5
    assert float(((y - y.round()).abs() < 2.0 ** -8).double().mean()) >= 0.9 / nbase
    assert torch.equal(sc8, want), C.step_diff(sc8, want)


# (cin, cm, n, h): RN50 stage 1, a ragged width (Cm 320), RN50 stages 2 and 4, and
# RN50x16's stage 4 (C 3072: one ring stage beside the resident 64 × C tile).
@pytest.mark.parametrize("cin,cm,n,h", [(256, 64, 2, 7), (1280, 320, 2, 14),
                                        (512, 128, 64, 28), (2048, 512, 8, 7),
                                        (3072, 768, 2, 12)])
def test_cb3_cb1_kernel_matches_plain_version(cuda, cin, cm, n, h):
    """K4 vs its plain version, bit-exact (K = C > 1024 included); a second launch on
    the same input is bit-equal."""
    rng = np.random.RandomState(1)
    q, names = C.identity_q(rng, cin, cm, 2)
    q = C.to_torch(q, cuda)
    ops = Q.cb3_cb1_operands(q, names[0], names[1], torch.tensor(1.9 / 127, device=cuda))
    x8 = _t(C.s8(rng, (n, h, h, cm)), cuda)
    res8 = _t(C.s8(rng, (n, h, h, cin)), cuda)
    before = BK.fused_cb3_cb1_int8.launches
    out8, y8 = BK.fused_cb3_cb1_int8(x8, res8, ops)
    again8, againy = BK.fused_cb3_cb1_int8(x8, res8, ops)
    torch.cuda.synchronize()
    assert BK.fused_cb3_cb1_int8.launches == before + 2
    ref8, refy = BK.fused_cb3_cb1_int8_reference(x8, res8, ops)
    assert torch.equal(out8, ref8) and torch.equal(y8, refy)
    assert torch.equal(out8, again8) and torch.equal(y8, againy)


# (cin, cm, nb, n, h, out): test widths, RN50 stage 2 (s8, and f32 out), stage 4, the
# main path's stage 4 at batch 128 (bf16 conv map), a ragged M (3·7·7 = 147 rows),
# RN50x16's stage 2 (Cm 192) and stage 4 (C 3072: K4's one-stage ring inside K5).
@pytest.mark.parametrize("cin,cm,nb,n,h,out_dtype", [
    (32, 16, 3, 2, 6, torch.int8), (32, 16, 3, 2, 6, torch.bfloat16),
    (32, 16, 2, 2, 6, torch.float32), (512, 128, 3, 4, 28, torch.int8),
    (2048, 512, 2, 2, 7, torch.bfloat16), (512, 128, 2, 4, 28, torch.float32),
    (2048, 512, 2, 128, 7, torch.bfloat16), (1024, 256, 2, 3, 7, torch.int8),
    (768, 192, 2, 2, 24, torch.int8), (3072, 768, 2, 2, 12, torch.bfloat16)])
def test_resblocks_kernel_matches_plain_version(cuda, cin, cm, nb, n, h, out_dtype):
    """K5 vs its plain version, bit-exact, s8 and conv-map (bf16/f32) outputs; a second
    launch on the same input is bit-equal."""
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
    again = BK.fused_resblocks_int8(x8, ops, scl, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert BK.fused_resblocks_int8.launches == before + 2
    want = BK.fused_resblocks_int8_reference(x8, ops, scl, out_dtype=out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)
    assert torch.equal(got, again)


# Each int8 kernel in the reciprocal requant form at a few of the shapes above: K2 and K3
# within their contract of their plain version in that form, K4 and K5 bit-exact. Against
# the division form: a single requant in the reciprocal form (K2's, before its pool; K4's
# block output; K5's s8 output) moves by at most one s8 step; the outputs of chained ones
# (K4's next cb1, K3's third block output) carry a flipped step through the later convs,
# so there only the share is held (≤0.5%).
RECIP_CASES = [("K2", (3, 112, 112, 32, 64)), ("K2", (2, 16, 16, 8, 16)),
               ("K3", (2, 56, 64, 64, 256)), ("K3", (2, 16, 16, 16, 64)),
               ("K3", (2, 24, 96, 96, 384)), ("K4", (256, 64, 2, 7)),
               ("K4", (2048, 512, 8, 7)), ("K5", (512, 128, 3, 4, 28)),
               ("K5", (2048, 512, 2, 2, 7))]


def _recip_call(kernel, shape, dev):
    """(wrapper, plain version, args, kw) of one kernel call at `shape`."""
    rng = np.random.RandomState(9)
    if kernel == "K2":
        n, h, w, cin, cout = shape
        x = _t(np.abs(rng.randn(n, h, w, cin)).astype(np.float32) * 0.5, dev, torch.bfloat16)
        args = (x, _t(rng.randn(3, 3, cin, cout).astype(np.float32) * 0.1, dev),
                _t(rng.randn(cout).astype(np.float32) * 0.05, dev),
                torch.tensor(2.3 / 127, device=dev))
        return SK.stem3_requant_pool_int8, SK.stem3_requant_pool_int8_reference, args, {}
    if kernel == "K3":
        n, h, cin, cm, cout = shape
        ops = Q.stage1_int8_operands(C.to_torch(C.stage1_q(rng, cin, cm, cout), dev))
        return (BK.fused_stage1_int8, BK.fused_stage1_int8_reference,
                (_t(C.s8(rng, (n, h, h, cin)), dev), ops), {})
    if kernel == "K4":
        cin, cm, n, h = shape
        q, names = C.identity_q(rng, cin, cm, 2)
        ops = Q.cb3_cb1_operands(C.to_torch(q, dev), names[0], names[1],
                                 torch.tensor(1.9 / 127, device=dev))
        args = (_t(C.s8(rng, (n, h, h, cm)), dev), _t(C.s8(rng, (n, h, h, cin)), dev), ops)
        return BK.fused_cb3_cb1_int8, BK.fused_cb3_cb1_int8_reference, args, {}
    cin, cm, nb, n, h = shape
    q, names = C.identity_q(rng, cin, cm, nb)
    q = C.to_torch(q, dev)
    ops, scl = Q.resblocks_int8_operands(q, names, torch.tensor(1.8 / 127, device=dev),
                                         q["act_scales"][f"{names[-1]}.out"])
    return (BK.fused_resblocks_int8, BK.fused_resblocks_int8_reference,
            (_t(C.s8(rng, (n, h, h, cin)), dev), ops, scl), {})


@pytest.mark.parametrize("kernel,shape", RECIP_CASES)
def test_int8_kernels_in_the_reciprocal_form_match_plain_versions(cuda, kernel, shape):
    fn, ref, args, kw = _recip_call(kernel, shape, cuda)
    before = fn.launches
    got = fn(*args, **kw, recip=True)
    div = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    want = ref(*args, **kw, recip=True)
    pairs = list(zip(got, want, div)) if isinstance(got, tuple) else [(got, want, div)]
    for i, (g, w, d) in enumerate(pairs):
        assert g.shape == w.shape and g.dtype == w.dtype
        if kernel in ("K2", "K3"):
            dmax, frac = C.step_diff(g, w)
            assert dmax <= 1 and frac <= 0.005, (dmax, frac)
        else:
            assert torch.equal(g, w)
        form_step, form_share = C.step_diff(g, d)
        assert form_share <= 0.005, (form_step, form_share)
        if kernel in ("K2", "K5") or (kernel == "K4" and i == 0):
            assert form_step <= 1, (form_step, form_share)


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


def test_int8_rn50x16_paths_on_the_card(cuda):
    """`clip_rn50x16` int8 on the card at its full widths (384 px, random weights):
    path A (K2 + K5 on stages 2-4) and path B (K2 + K4 at every block boundary, stage 1's
    C = 384 and stage 4's C = 3072 included) are bit-identical and within 1e-3 cosine of
    the plain int8 graph (K2 skips the graph's bf16 rounding of the stem3 conv)."""
    enc = build_encoder("clip_rn50x16", dtype=torch.bfloat16, device="cuda").fold_bn()
    qenc = enc.quantize(golden_frames(4))
    frames = golden_frames(2, size=384)
    counted = (SK.stem3_requant_pool_int8, BK.fused_resblocks_int8, BK.fused_cb3_cb1_int8)
    outs, launches = {}, {}
    for path, switches in (("A", Q.PATH_A), ("B", Q.PATH_B), ("off", Q.KERNELS_OFF)):
        before = [f.launches for f in counted]
        outs[path] = qenc.with_kernels(**switches).encode(frames)
        torch.cuda.synchronize()
        launches[path] = [f.launches - b for f, b in zip(counted, before)]
    assert launches == {"A": [1, 3, 0], "B": [1, 0, 6 + 8 + 18 + 8 - 1], "off": [0, 0, 0]}
    conv = outs["A"]["clip_conv"]
    assert conv.shape == (2, 12, 12, 3072) and bool(torch.isfinite(conv.float()).all())
    assert all(torch.equal(outs["A"][k], outs["B"][k]) for k in outs["A"])
    assert cosine_distance(conv, outs["off"]["clip_conv"]) <= 1e-3


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


def test_int8_kernels_need_widths_of_16_and_kmajor_copies(cuda):
    """The s8 tensor-core kernels take C, Cm and N in multiples of 16 (TMA's 16-byte row
    strides) and the K-major weight copies of the operand builders; they never build
    those per call."""
    rng = np.random.RandomState(9)
    q, names = C.identity_q(rng, 40, 24, 2)  # C = 40, Cm = 24: not multiples of 16
    q = C.to_torch(q, cuda)
    r = torch.tensor(0.01, device=cuda)
    ops = Q.cb3_cb1_operands(q, names[0], names[1], r)
    with pytest.raises(ValueError, match="multiple of 16"):
        BK.fused_cb3_cb1_int8(_t(C.s8(rng, (2, 6, 6, 24)), cuda),
                              _t(C.s8(rng, (2, 6, 6, 40)), cuda), ops)
    q, names = C.identity_q(rng, 32, 16, 2)
    q = C.to_torch(q, cuda)
    x8 = _t(C.s8(rng, (2, 6, 6, 16)), cuda)
    res8 = _t(C.s8(rng, (2, 6, 6, 32)), cuda)
    ops = Q.cb3_cb1_operands(q, names[0], names[1], r)
    bare = {k: v for k, v in ops.items() if not k.endswith("_t")}
    with pytest.raises(ValueError, match="K-major"):
        BK.fused_cb3_cb1_int8(x8, res8, bare)
    blocks, scl = Q.resblocks_int8_operands(q, names, r, r)
    with pytest.raises(ValueError, match="K-major"):
        BK.fused_resblocks_int8(res8, [{k: v for k, v in b.items() if k != "k2_t"}
                                       for b in blocks], scl)
    with pytest.raises(ValueError, match="multiple of 16"):
        BK.fused_resblocks_int8(res8[..., :24].contiguous(), blocks, scl)


def test_cb3_cb1_refuses_a_block_output_too_wide_for_shared_memory(cuda):
    """K4 keeps a 64-row tile of the block output resident: C = 4096 (256 KB) cannot fit,
    and the kernel's entry point refuses it before any launch."""
    rng = np.random.RandomState(10)
    q, names = C.identity_q(rng, 4096, 16, 2)
    q = C.to_torch(q, cuda)
    ops = Q.cb3_cb1_operands(q, names[0], names[1], torch.tensor(0.01, device=cuda))
    with pytest.raises(RuntimeError, match="too wide"):
        BK.fused_cb3_cb1_int8(_t(C.s8(rng, (1, 2, 2, 16)), cuda),
                              _t(C.s8(rng, (1, 2, 2, 4096)), cuda), ops)


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


# (n, h, c, cm): test width (Cm 8), RN50 stages 2-4, RN50x16 stages 3-4, the main path's
# stage 4 at batch 128 (more output tiles than SMs), a ragged stage 3 (M = 147).
@pytest.mark.parametrize("n,h,c,cm", [(2, 6, 32, 8), (2, 10, 64, 16), (4, 28, 512, 128),
                                      (4, 14, 1024, 256), (16, 7, 2048, 512),
                                      (2, 24, 1536, 384), (2, 12, 3072, 768),
                                      (128, 7, 2048, 512), (3, 7, 1024, 256)])
def test_fused_bottleneck_kernel_matches_plain_version(cuda, n, h, c, cm):
    """K6 vs its plain version (bf16, f32 accumulation): the card contract; a second
    launch on the same input is bit-equal (the persistent tile walk is deterministic)."""
    rng = np.random.RandomState(6)
    blk = _bf16_block(rng, c, cm, c, cuda)
    x = _t(np.abs(rng.randn(n, h, h, c)).astype(np.float32), cuda, torch.bfloat16)
    args = (x, blk["w1"], blk["b1"], blk["w2"], blk["b2"], blk["w3"], blk["b3"])
    before = BK.fused_bottleneck.launches
    got = BK.fused_bottleneck(*args)
    again = BK.fused_bottleneck(*args)
    torch.cuda.synchronize()
    assert BK.fused_bottleneck.launches == before + 2
    assert torch.equal(got, again)
    _assert_bf16_contract(got, BK.fused_bottleneck_reference(*args))


# (n, h, cin, cm, cout, blocks): RN50 stage 1, RN50x16 stage 1, clip_rn_tiny's 1 block.
@pytest.mark.parametrize("n,h,cin,cm,cout,nb", [(2, 56, 64, 64, 256, 3),
                                                (1, 96, 96, 96, 384, 3),
                                                (2, 8, 8, 8, 32, 1)])
def test_fused_stage1_kernel_matches_plain_version(cuda, n, h, cin, cm, cout, nb):
    """K7 vs its plain version (bf16, f32 accumulation): the card contract block by
    block (`parity.stage1_block_disagreements`); the chained output is reported. A
    second launch on the same input is bit-equal."""
    rng = np.random.RandomState(7)
    blocks = [_bf16_block(rng, cin if i == 0 else cout, cm, cout, cuda) for i in range(nb)]
    shortcut = (_t(rng.randn(cin, cout).astype(np.float32) / np.sqrt(cin), cuda,
                   torch.bfloat16), _t(rng.randn(cout).astype(np.float32) * 0.1, cuda))
    x = _t(np.abs(rng.randn(n, h, h, cin)).astype(np.float32), cuda, torch.bfloat16)
    before = BK.fused_stage1.launches
    got = BK.fused_stage1(x, blocks, shortcut)
    again = BK.fused_stage1(x, blocks, shortcut)
    torch.cuda.synchronize()
    assert BK.fused_stage1.launches == before + 2
    assert got.shape == (n, h, h, cout)
    assert torch.equal(got, again)
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


def test_ddppo_iteration_with_the_encoder_in_the_rollout(cuda):
    """One DD-PPO iteration on the card with the bf16 folded `clip_rn_tiny` encoder
    inside the rollout: a finite loss, changed weights, and per iteration T + 1 encodes,
    each launching K1 and K7 once (its trunk has no stride-1 identity block for K6)."""
    from embodied_clip_tpu_torch.envs.gridworld import GridNavEnv
    from embodied_clip_tpu_torch.models.policy import ActorCritic
    from embodied_clip_tpu_torch.training.ddppo import DDPPOConfig, DDPPOLearner
    from embodied_clip_tpu_torch.training.frames import frozen_encode_fn
    from embodied_clip_tpu_torch.training.ppo import PPOConfig

    fe, is_map = frozen_encode_fn("clip_rn_tiny", torch.bfloat16, device="cuda")
    env = GridNavEnv(size=5, max_steps=8, frame_obs=True)
    policy = ActorCritic(env.num_actions, fe.feature_shape, hidden=32,
                         visual_is_map=is_map)
    learner = DDPPOLearner(env, policy, DDPPOConfig(rollout_len=4, env_batch=3,
                                                    ppo=PPOConfig(epochs=2)),
                           encode_fn=fe, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    act = learner.init(gen)
    before = [p.detach().clone() for p in policy.parameters()]
    counted = (K.fused_preprocess, BK.fused_stage1, BK.fused_bottleneck)
    start = [f.launches for f in counted]
    act, metrics = learner.train_iteration(act, gen)
    torch.cuda.synchronize()
    assert [f.launches - s for f, s in zip(counted, start)] == [5, 5, 0]
    assert np.isfinite(float(metrics["loss"]))
    assert any(not torch.equal(a, b) for a, b in zip(before, policy.parameters()))
    assert act.obs["visual"].is_cuda and act.h.is_cuda


def test_fused_preprocess_kernel_at_the_rollout_shape(cuda):
    """K1 at the DD-PPO rollout's shape: 32 GridNav frames of 56x56, upscaled to 224."""
    from embodied_clip_tpu_torch.envs.gridworld import GridNavEnv

    env = GridNavEnv(size=8, frame_obs=True)
    _, obs = env.reset(torch.Generator(device="cuda").manual_seed(0), 32)
    x = obs["visual"]
    assert x.shape == (32, 56, 56, 3) and x.dtype == torch.uint8 and x.is_cuda
    got = K.fused_preprocess(x, 224, MEAN, STD, dtype=torch.float32)
    got_bf16 = K.fused_preprocess(x, 224, MEAN, STD, dtype=torch.bfloat16)
    ref = K.fused_preprocess_reference(x, 224, MEAN, STD, dtype=torch.float32)
    lsb = 1.0 / 255.0 / min(STD)
    err = (got - ref).abs()
    assert float(err.max()) <= 1.5 * lsb
    assert float((err > 0.5 * lsb).float().mean()) < 1e-3
    assert torch.equal(got_bf16, got.to(torch.bfloat16))


def test_host_act_steps_with_the_ring_after_cuda_is_up(cuda):
    """The host-simulator path on the card: a 2-worker `VectorEnv` of `HostGridNav`
    started after CUDA is up (its workers come from the fork server, which holds no CUDA
    context) with the shared-memory ring live, one `collect` of 3 steps through the bf16
    folded `clip_rn_tiny` encoder: T + 1 encodes a collect, each launching K1 and K7
    once; the stored features on the card, finite; a worker SIGKILLed between collects
    is respawned and its next transition masked invalid."""
    from embodied_clip_tpu_torch.envs.vector import VectorEnv
    from embodied_clip_tpu_torch.models.policy import ActorCritic
    from embodied_clip_tpu_torch.native.frame_ring import frame_ring_available
    from embodied_clip_tpu_torch.training.frames import frozen_encode_fn
    from embodied_clip_tpu_torch.training.host_rollout import HostRolloutCollector

    import torch_host_cases as H

    fe, is_map = frozen_encode_fn("clip_rn_tiny", torch.bfloat16, device="cuda")
    torch.cuda.synchronize()  # CUDA is up before the pool starts
    assert frame_ring_available()
    venv = VectorEnv(H.hostgrid_fns(range(2)), frame_shape=H.FRAME)
    try:
        assert venv.ring is not None
        policy = ActorCritic(6, fe.feature_shape, hidden=32, visual_is_map=is_map).cuda()
        col = HostRolloutCollector(venv, policy, encode_fn=fe, device="cuda")
        col.reset(0)
        counted = (K.fused_preprocess, BK.fused_stage1)
        start = [f.launches for f in counted]
        roll, last, _ = col.collect(3)
        torch.cuda.synchronize()
        assert [f.launches - s for f, s in zip(counted, start)] == [4, 4]
        v = roll.obs["visual"]
        assert v.is_cuda and v.shape == (3, 2) + fe.feature_shape
        assert bool(torch.isfinite(v.float()).all()) and bool(torch.isfinite(last).all())
        assert bool(roll.valid.all())
        venv.procs[1].kill()
        venv.procs[1].join(timeout=5)
        roll, _, _ = col.collect(3)
        assert venv.respawn_count == 1 and venv.procs[1].is_alive()
        assert not bool(roll.valid[:, 1].all()) and bool(roll.valid[:, 0].all())
    finally:
        venv.close()


def test_host_ppo_in_two_nccl_processes_equals_one(cuda):
    """Multi-process host DD-PPO on the cards: pools of 3 and 2 envs (offsets 0 and 3) in
    two processes joined by NCCL, one card each, update as one process with the pool of
    5 does on one card (a rollout of the port's GridNav, 2 epochs × 3 minibatches, about
    a fifth of the steps masked invalid): metrics within 1e-6, weights within 1e-6
    wherever every step's gradient is at least 1e-6 and within 2·lr a step below
    (`torch_rl_cases.assert_adam_close`)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from embodied_clip_tpu_torch.envs.gridworld import GridNavEnv
    from embodied_clip_tpu_torch.parallel import dryrun
    from embodied_clip_tpu_torch.training.ddppo import DDPPOConfig
    from embodied_clip_tpu_torch.training.ppo import PPOConfig
    from embodied_clip_tpu_torch.training.rollout import collect_rollout, init_act_state

    import torch_host_cases as H
    import torch_rl_cases as RC

    T, B = 4, 5
    env, pol = GridNavEnv(**RC.ENV_KW), RC.port_policy()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        roll, last, _, _ = collect_rollout(env, pol, init_act_state(env, gen, B, RC.HIDDEN),
                                           T, gen)
    roll = roll._replace(valid=torch.from_numpy(RC.random_valid(T, B, seed=3)))
    sd = pol.state_dict()
    cfg = DDPPOConfig(rollout_len=T, num_minibatches=3, ppo=PPOConfig(epochs=2, lr=1e-3))
    want_sd, want_m, grads = H.host_update_rank(sd, roll, last, cfg, (B,), "cuda")
    ranks = dryrun.run_ranks(2, H.host_update_rank, sd, roll, last, cfg, (3, 2), "cuda",
                             timeout=240, device="cuda")
    grads = {k: torch.from_numpy(v) for k, v in grads.items()}
    for got_sd, got_m, _ in ranks:
        RC.assert_adam_close(got_sd, want_sd, grads, cfg.ppo.lr, 2 * 3)
        for k in want_m:
            assert abs(got_m[k] - want_m[k]) <= 1e-6, k


@pytest.mark.parametrize("m", [50, 6400])
def test_qmm_at_the_vit_b32_shapes_equals_the_cpu(cuda, m):
    """`qmm` on the card at ViT-B/32's dense shapes (batch 1: 50 tokens; batch 128: 6400)
    is bit-equal to `torch._int_mm` on the CPU: s8 × s8 → s32 is exact."""
    gen = torch.Generator().manual_seed(m)
    for k, n in ((768, 2304), (768, 768), (768, 3072), (3072, 768)):
        a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen, dtype=torch.int8)
        got = qmm(a.to(cuda), w.to(cuda).t())  # the weight as the int8 ViT stores it
        assert torch.equal(got.cpu(), torch._int_mm(a, w.t().contiguous())), (m, k, n)


def test_int8_vit_encode_on_the_card_matches_the_cpu(cuda):
    """The int8 `clip_vit_b32` (bf16, the serving configuration) quantized and run on the
    card lies within 1e-3 cosine of the same encoder (same seed, same calibration frames)
    quantized and run on the CPU: K1 against its plain version, cuBLAS's bf16 and s8
    products against the CPU's."""
    calib, frames = golden_frames(8), golden_frames(4, seed=1)
    out = {}
    for dev in ("cuda", "cpu"):
        enc = build_encoder("clip_vit_b32", dtype=torch.bfloat16, device=dev)
        before = K.fused_preprocess.launches
        out[dev] = enc.quantize(calib).encode(frames)["clip_embed"]
        launched = K.fused_preprocess.launches - before
        assert launched == (2 if dev == "cuda" else 0)  # calibration and the encode
    assert out["cuda"].shape == (4, 512) and bool(torch.isfinite(out["cuda"].float()).all())
    assert cosine_distance(out["cuda"], out["cpu"]) <= 1e-3


def test_step_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A train state saved from the card (a policy's state_dict, `ClippedAdam`'s state
    and a CUDA generator's state) restores onto the card: the tensors come back on the
    card, equal, and the generator draws what it would have drawn."""
    from embodied_clip_tpu_torch.training.optim import ClippedAdam
    from embodied_clip_tpu_torch.utils.checkpoint import StepCheckpointer, restore_params

    pol = torch.nn.Linear(8, 4).to(cuda)
    tx = ClippedAdam(pol.parameters(), lr=1e-3, max_grad_norm=0.5, decay_updates=10)
    tx.step([torch.randn_like(p) for p in tx.params])
    gen = torch.Generator(device=cuda).manual_seed(5)
    torch.rand(16, generator=gen, device=cuda)
    state = {"params": pol.state_dict(), "opt_state": tx.state_dict(),
             "generator": [gen.get_state()]}
    ck = StepCheckpointer(str(tmp_path), prefix="exp")
    path = ck.save(64, state)
    want = torch.rand(16, generator=gen, device=cuda)

    pol2 = torch.nn.Linear(8, 4).to(cuda)
    tx2 = ClippedAdam(pol2.parameters(), lr=1e-3, max_grad_norm=0.5, decay_updates=10)
    gen2 = torch.Generator(device=cuda).manual_seed(0)
    template = {"params": pol2.state_dict(), "opt_state": tx2.state_dict(),
                "generator": [gen2.get_state()]}
    step, got = ck.restore_latest(template)
    assert step == 64
    pol2.load_state_dict(got["params"])
    tx2.load_state_dict(got["opt_state"])
    gen2.set_state(got["generator"][0])
    for k, v in pol2.state_dict().items():
        assert v.is_cuda and torch.equal(v, pol.state_dict()[k]), k
    assert tx2.count == 1 and all(m.is_cuda for m in tx2.mu)
    assert all(torch.equal(a, b) for a, b in zip(tx2.nu, tx.nu))
    assert torch.equal(torch.rand(16, generator=gen2, device=cuda), want)
    restored = restore_params(path, pol2.state_dict())
    assert all(v.is_cuda for v in restored.values())


@pytest.mark.parametrize("dtype,limits", [
    ("bfloat16", {"clip_conv": 1e-3, "clip_avgpool": 1e-3, "clip_attnpool": 1e-3}),
    # chip_smoke.py's INT8_COSINE_LIMITS
    ("int8", {"clip_conv": 2e-3, "clip_avgpool": 1e-3, "clip_attnpool": 1e-3})])
def test_extract_clip_rn50_on_the_card(cuda, tmp_path, dtype, limits):
    """A batch-8 extraction of `clip_rn50` (golden-frame textures, a planted object) on
    the card in bf16 (unfolded: K1) and int8 (K1-K3, K5), held to the f32 store."""
    from embodied_clip_tpu_torch.generate_data.extract import extract_thor_features

    d = tmp_path / "scenes" / "train"
    d.mkdir(parents=True)
    sem = np.zeros((300, 300, 3), np.uint8)
    sem[:100, :100] = (10, 20, 30)
    np.save(str(d / "FloorPlan1.npy"), [
        {"frame": f, "semantic_frame": sem, "object_id_to_color": {"Mug": (10, 20, 30)},
         "valid_moves_forward": 11} for f in golden_frames(8)])
    stores = {}
    for dt in ("float32", dtype):
        extract_thor_features(str(tmp_path / "scenes"), str(tmp_path / dt),
                              encoder_names=["clip_rn50"], batch_size=8, dtype=dt,
                              splits=("train",), device="cuda")
        with np.load(str(tmp_path / dt / "thor_train.npz")) as z:
            stores[dt] = {k: z[k] for k in z.files}
    got, ref = stores[dtype], stores["float32"]
    assert got["clip_conv"].shape == (8, 7, 7, 2048) and got["clip_attnpool"].shape == (8, 1024)
    for k, limit in limits.items():
        assert cosine_distance(got[k], ref[k]) <= limit, k
    assert got["object_localization"][:, 0].sum() == 8 and got["free_space"].tolist() == [11] * 8


def test_probe_fit_epoch_on_the_card_equals_the_cpu(cuda, tmp_path):
    """One `ProbeTrainer.fit` epoch on the card from the CPU run's initial params (TF32
    off): params and val/test metrics within 1e-4."""
    from embodied_clip_tpu_torch.data.probing import ProbeDataModule
    from embodied_clip_tpu_torch.training.supervised import ProbeTrainConfig, ProbeTrainer

    rng = np.random.RandomState(0)
    w = rng.randn(64, 52)
    for split, n in (("train", 512), ("val", 128), ("test", 128)):
        x = rng.randn(n, 64).astype(np.float32)
        np.savez(str(tmp_path / f"thor_{split}.npz"), clip_avgpool=x,
                 object_presence=(x @ w > 0).astype(np.int64))
    runs = {}
    for device in ("cpu", "cuda"):
        dm = ProbeDataModule(str(tmp_path), "clip_avgpool", "object_presence").setup()
        tr = ProbeTrainer(ProbeTrainConfig(max_epochs=1, device=device))
        val = tr.fit(dm)
        runs[device] = ({k: v.cpu() for k, v in tr.params.items()}, val, tr.test(dm))
    (pc, vc, tc), (pg, vg, tg) = runs["cpu"], runs["cuda"]
    for k in pc:
        assert (pc[k] - pg[k]).abs().max() <= 1e-4, k
    for a, b in ((vc, vg), (tc, tg)):
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-4, (k, a[k], b[k])
