"""CLIP's anti-aliased stride-2 blocks on the bf16 fused plan, on the CPU: the block's
plain version (`fused_stride_block_bf16_reference`, whose pools are `F.avg_pool2d`)
against `CLIPBottleneck.forward` in either memory layout and at odd sizes, the plan that
picks the step from the block's structure, and the counters a traced encode adds. The
launches themselves are held to these plain versions on the card (tests/test_torch_gpu.py).
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from embodied_clip_tpu_torch.models.clip_resnet import CLIPBottleneck, ModifiedResNet
from embodied_clip_tpu_torch.models.resnet import ResNet
from embodied_clip_tpu_torch.models.stages import _bottleneck_operands, _pointwise
from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
from embodied_clip_tpu_torch.parity import bf16_disagreement, cosine_distance
from embodied_clip_tpu_torch.utils.profiling import recorded, span


def _block(cin, planes, seed):
    """A folded bf16 CLIP stride-2 bottleneck with weights scaled so activations stay
    O(1), and the same block in f32 (the bf16 weights, exactly)."""
    g = torch.Generator().manual_seed(seed)
    blk = CLIPBottleneck(cin, planes, 2, torch.bfloat16, folded=True)
    with torch.no_grad():
        for p in blk.parameters():
            if p.ndim == 4:
                p.copy_(torch.randn(p.shape, generator=g) / p[0].numel() ** 0.5)
            else:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    f32 = CLIPBottleneck(cin, planes, 2, torch.float32, folded=True)
    f32.load_state_dict({k: v.float() for k, v in blk.state_dict().items()})
    ds = blk.downsample[1]
    ops = {**_bottleneck_operands(blk), "wds": _pointwise(ds), "bds": ds.bias.float()}
    return blk, f32, ops


# (Cin, planes, H = W): RNtiny's stage 2, RN50's stage 2 at a smaller map, and an odd map
# (the pools' floor rule).
@pytest.mark.parametrize("cin,planes,hw", [(32, 16, 16), (256, 128, 20), (256, 128, 15)])
def test_block_plain_version_matches_clip_bottleneck(cin, planes, hw):
    """In f32 the plain version is the module's forward (the same products and sums);
    in bf16 it stays within `parity.bf16_disagreement`'s allowance of the f32 forward
    (the share half of that rule compares two bf16 computations: against f32 every
    rounding of h1, h2, the pools and the output shows), and rounds fewer times than the
    module's own bf16 forward, so it lies no further from f32 and differs from the f32
    forward's bf16 rounding on no more elements."""
    blk, f32, ops = _block(cin, planes, seed=cin + hw)
    g = torch.Generator().manual_seed(hw)
    x = torch.randn(2, hw, hw, cin, generator=g).abs().to(torch.bfloat16)
    with torch.no_grad():
        want = f32(x.float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        module = blk(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got32 = BK.fused_stride_block_bf16_reference(x.float(), **ops)
        got = BK.fused_stride_block_bf16(x, **ops)  # a CPU tensor takes the plain version
    assert got.shape == want.shape == (2, hw // 2, hw // 2, 4 * planes)
    torch.testing.assert_close(got32, want, atol=1e-5, rtol=1e-5)
    assert torch.equal(got, BK.fused_stride_block_bf16_reference(x, **ops))
    _, worst = bf16_disagreement(got, want)
    _, module_worst = bf16_disagreement(module, want)
    share, _ = bf16_disagreement(got, want.to(torch.bfloat16))
    module_share, _ = bf16_disagreement(module, want.to(torch.bfloat16))
    assert worst <= 1.0, worst
    assert share <= module_share and worst <= module_worst, (share, module_share)
    assert cosine_distance(got, want) <= 1e-4


@pytest.mark.parametrize("h,w", [(8, 8), (7, 9), (5, 4), (3, 5)])
@pytest.mark.parametrize("channels_last", [True, False])
def test_block_plain_version_takes_either_layout(h, w, channels_last):
    """The route's plain version on a contiguous NHWC tensor and on the NHWC view of NCHW
    memory (what `run_stages` hands it from an unconverted input) gives the same bits,
    odd H and W floor-sized as the module's pools are; in f32 it is the module's forward."""
    blk, f32, ops = _block(16, 8, seed=h * 16 + w)
    g = torch.Generator().manual_seed(h * 16 + w)
    nchw = torch.randn(2, 16, h, w, generator=g).abs().to(torch.bfloat16)
    if channels_last:
        nchw = nchw.contiguous(memory_format=torch.channels_last)
    x = nchw.permute(0, 2, 3, 1)
    with torch.no_grad():
        got = BK.fused_stride_block_bf16_reference(x, **ops)
        want = f32(nchw.float()).permute(0, 2, 3, 1)
        got32 = BK.fused_stride_block_bf16_reference(x.float(), **ops)
    assert got.shape == (2, h // 2, w // 2, 32) and got.dtype == torch.bfloat16
    ref = BK.fused_stride_block_bf16_reference(x.contiguous(), **ops)
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
    torch.testing.assert_close(got32, want, atol=1e-5, rtol=1e-5)


def test_fused_plan_takes_clip_stride_blocks_by_structure():
    """Folded bf16 CLIP RN50: K7, then the three stride blocks on the `stride` step.
    torchvision's RN50 (the stride inside conv2 and the shortcut conv), an f32 trunk, an
    unfolded one and a CLIP stride block that is not 8 wide keep their routes."""
    rn50 = ModifiedResNet((3, 4, 6, 3), 64, torch.bfloat16, folded=True)
    kinds = [k for k, _ in rn50.fused_plan()]
    assert kinds == (["stage1", "stride"] + ["bottleneck"] * 3 + ["stride"]
                     + ["bottleneck"] * 5 + ["stride"] + ["bottleneck"] * 2)
    assert [m for k, m in rn50.fused_plan() if k == "stride"] == [
        rn50.layer2[0], rn50.layer3[0], rn50.layer4[0]]
    tv50 = ResNet((3, 4, 6, 3), "bottleneck", dtype=torch.bfloat16, folded=True)
    assert "stride" not in {k for k, _ in tv50.fused_plan()}
    assert not ModifiedResNet((1, 1, 1, 1), 8, torch.float32, folded=True).runs_fused_plan
    assert not ModifiedResNet((1, 1, 1, 1), 8, torch.bfloat16).runs_fused_plan
    narrow = ModifiedResNet((1, 1, 1, 1), 6, torch.bfloat16, folded=True)  # planes 12, 24, 48
    assert [k for k, _ in narrow.fused_plan()] == ["stage1", "module", "stride", "stride"]


def test_traced_encode_counts_the_stride_blocks():
    """One traced encode of a folded bf16 CLIP tower adds 3 to both counters (block 0 of
    stages 2-4, all on the launches); torchvision's ResNet-18 counts its 3 stride-2
    blocks and fuses none. Each CLIP stride block is one `bf16.block` span."""
    from embodied_clip_tpu_torch.models.encoders import build_encoder
    from embodied_clip_tpu_torch.parity import golden_frames

    frames = golden_frames(2, 60)
    for name, fused, blocks in (("clip_rn_tiny", 3, 3), ("imagenet_rn18", 0, 8)):
        enc = build_encoder(name, torch.bfloat16, device="cpu").fold_bn()
        with span("between"):  # a span call with the profiler off ends the last session
            pass
        with profile(activities=[ProfilerActivity.CPU]):
            enc.encode(frames)
        rec = recorded()
        assert rec.counters.get("bf16.stride_blocks") == 3
        assert rec.counters.get("bf16.stride_fused", 0) == fused
        assert rec.by_name()["bf16.block"].calls == blocks
