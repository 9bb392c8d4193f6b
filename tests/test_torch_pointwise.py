"""The per-element launches of the CLIP transformer blocks (`ops/kernels/pointwise_kernel.py`)
on the CPU: their plain versions are today's chains (`layer_norm_f32(x, ln).to(bf16)`,
`x + d` in bf16, `quick_gelu`), the gate sends nothing but fitting CUDA tensors to the
launches, and the blocks and the ViT built on them give the outputs of the chains they
replace, bit for bit. No JAX: the chains are the port's own (the JAX parity of the blocks
is `tests/test_torch_clip_vit.py`'s). The launches themselves run in
`tests/test_torch_gpu.py` and `chip_smoke.py` phase 16.
"""

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.harness.weights import fill_, seeded_generator
from embodied_clip_tpu_torch.models.clip_vit import VisionTransformer, patch_embed
from embodied_clip_tpu_torch.models.transformer import (ResidualAttentionBlock, layer_norm_f32,
                                                        quick_gelu)
from embodied_clip_tpu_torch.ops.kernels import pointwise_kernel as PK

BF16 = torch.bfloat16
WIDTHS = (32, 512, 768, 1024)
ROWS = ((1,), (7,), (3, 5))


def _ln(c: int, seed: int) -> nn.LayerNorm:
    g = torch.Generator().manual_seed(seed)
    ln = nn.LayerNorm(c)
    with torch.no_grad():
        ln.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
        ln.bias.copy_(0.05 * torch.randn(c, generator=g))
    return ln


def _x(rows, c: int, seed: int, scale: float = 1.5) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(*rows, c, generator=g)
            + 0.5 * torch.randn(*rows, 1, generator=g)).to(BF16)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("c", WIDTHS)
def test_layer_norm_plain_is_the_chain(c, rows):
    ln, x = _ln(c, c), _x(rows, c, c + 1)
    d = _x(rows, c, c + 2, scale=0.5)
    chain = F.layer_norm(x.float(), (c,), ln.weight, ln.bias, ln.eps).to(BF16)
    assert torch.equal(PK.layer_norm_plain(x, ln), chain)
    s, y = PK.layer_norm_plain(x, ln, d)
    assert s.dtype == BF16 and torch.equal(s, x + d)
    assert torch.equal(y, layer_norm_f32(x + d, ln).to(BF16))
    before = PK.layer_norm_bf16.launches
    assert torch.equal(PK.layer_norm_bf16(x, ln), chain)
    s2, y2 = PK.layer_norm_bf16(x, ln, d)
    assert torch.equal(s2, s) and torch.equal(y2, y)
    assert PK.layer_norm_bf16.launches == before   # the CPU takes the plain version


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("c", WIDTHS)
def test_quick_gelu_plain_is_the_chain(c, rows):
    y = _x(rows, 4 * c, c + 3)
    chain = y * torch.sigmoid(1.702 * y)
    assert PK.quick_gelu is quick_gelu and torch.equal(quick_gelu(y), chain)
    before = PK.quick_gelu_bf16.launches
    assert torch.equal(PK.quick_gelu_bf16(y), chain)
    assert PK.quick_gelu_bf16.launches == before


def test_gate_refuses_what_the_launches_do_not_take():
    """`fits` is the launches' shapes and layouts on any device; `kernel_takes` adds the
    card, so on the CPU it refuses everything."""
    ln = _ln(64, 0)
    x = _x((4,), 64, 1)
    assert PK.fits(x) and PK.fits(x, x.clone(), ln)
    assert not PK.kernel_takes(x) and not PK.kernel_takes(x, x.clone(), ln)   # the CPU
    assert not PK.fits(x.float()) and not PK.fits(x.float(), ln=ln)           # f32
    assert not PK.fits(x.t()) and not PK.fits(x[:, ::2])                      # strided
    buf = torch.zeros(x.numel() + 1, dtype=BF16)
    assert not PK.fits(buf[1:].view(x.shape))                                 # misaligned
    assert not PK.fits(_x((4,), 12, 2)) and not PK.fits(_x((4,), 12, 2), ln=_ln(12, 0))
    assert not PK.fits(x, x[:2].clone(), ln) and not PK.fits(x, x.float(), ln)
    assert not PK.fits(x, ln=_ln(32, 0))                     # ln of another width
    assert PK.fits(_x((2,), 8192, 3)) and not PK.fits(_x((2,), 8192, 3), ln=_ln(8192, 0))
    ln64 = _ln(64, 0).double()
    assert not PK.fits(x, ln=ln64)                           # non-f32 affine parameters


def _block(width: int, heads: int, dtype, seed: int) -> ResidualAttentionBlock:
    blk = ResidualAttentionBlock(width, heads, dtype)
    fill_(blk, seeded_generator(seed, 0, "cpu"))
    return blk


def _chain_block(blk, x, mask=None):
    """`ResidualAttentionBlock.forward` as it read before the launches."""
    x = x + blk.attn(layer_norm_f32(x, blk.ln_1).to(blk.dtype), mask)
    y = blk.mlp.c_fc(layer_norm_f32(x, blk.ln_2).to(blk.dtype))
    return x + blk.mlp.c_proj(quick_gelu(y))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("width,heads,t", [(32, 4, 17), (64, 2, 5)])
def test_block_on_the_cpu_is_the_chain(width, heads, t, dtype, masked):
    blk = _block(width, heads, dtype, seed=width + t)
    x = _x((3, t), width, 9).to(dtype)
    mask = (torch.full((t, t), float("-inf")).triu(1) if masked else None)
    with torch.no_grad():
        assert torch.equal(blk(x, mask), _chain_block(blk, x, mask))


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_vit_on_the_cpu_is_the_chain(dtype):
    cfg = dict(patch_size=16, width=32, layers=2, num_heads=4, output_dim=16, image_size=64)
    vit = VisionTransformer(**cfg, dtype=dtype)
    fill_(vit, seeded_generator(4, 0, "cpu"))
    g = torch.Generator().manual_seed(5)
    images = torch.randn(2, 64, 64, 3, generator=g)
    with torch.no_grad():
        x = patch_embed(images.to(dtype), vit.conv1.weight)
        x = torch.cat([vit.class_embedding.expand(2, 1, -1), x], dim=1) + vit.positional_embedding
        x = layer_norm_f32(x, vit.ln_pre).to(dtype)
        for blk in vit.transformer.resblocks:
            x = _chain_block(blk, x)
        want = torch.matmul(layer_norm_f32(x[:, 0], vit.ln_post), vit.proj).to(dtype)
        assert torch.equal(vit(images), want)


def test_layer_norm_step_disagreement_counts_steps_from_the_floor():
    """A one-step move of an output counts 1; a gap near zero counts in steps at
    `LN_STEP_FLOOR`, not at the tiny value's own spacing."""
    from embodied_clip_tpu_torch.parity import LN_STEP_FLOOR, layer_norm_step_disagreement

    want = torch.tensor([1.0, -0.75, 3e-6, 0.0, 2.0 ** -3], dtype=BF16)
    assert layer_norm_step_disagreement(want, want) == (0.0, 0.0)
    got = want.clone()
    got[0] = 1.0 + 2.0 ** -7   # the next bf16 value up
    assert layer_norm_step_disagreement(got, want) == (pytest.approx(0.2), 1.0)
    got = want.clone()
    got[2] = 2e-6   # many steps of 3e-6, a fraction of one at the floor
    share, steps = layer_norm_step_disagreement(got, want)
    assert share == pytest.approx(0.2) and 0 < steps < 1
    got[3] = LN_STEP_FLOOR * 2.0 ** -8   # a step at the floor's binade, from 0
    assert layer_norm_step_disagreement(got, want)[1] == 0.5
