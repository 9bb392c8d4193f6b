"""CLIP ViT-L/14@336px in the port (`models/clip_vit.py`, `models/encoders.py`) and the
fused attention's plain version (`ops/kernels/attention_kernel.py`), on the CPU. No JAX:
the JAX package lists no ViT-L, so the port is held to the benchmark's plain f32
reference (`benchmark/reference/clip_vision_transformer.py`, openai/CLIP's
`VisionTransformer` written out in torch).

Tolerances:
- the port's f32 ViT against the reference at a small size of the same structure (patch
  14 at 56 px: 17 tokens; width 64, 2 blocks, 4 heads): atol = rtol = 5e-4, the limit
  `tests/test_torch_clip_vit.py` uses (the same f32 arithmetic in another order: the
  patch embed as a matmul); its bf16 ViT within 1e-3 cosine distance of the reference,
  the north star that file holds the bf16 encoder to;
- attention, as the largest relative L2 gap of a row (one token's output) over the
  inputs of `_qkv` (logits of std ~2.9, as a trained ViT's spread):
  - `attention_plain` against the float64 softmax of the same bf16 inputs: 2^-8. Its
    output is rounded to bf16 (a row's relative error up to 2^-9) and its probabilities
    are bf16 (each within 2^-9 relative, the errors spread over the row): together
    under 2 · 2^-9;
  - `attention_plain` against `attention_core`: 2^-7, twice that, since each of the two
    bf16 routes lies within 2^-8 of the exact softmax;
  - the plain version with its logits rounded to bf16 before the softmax falls outside
    2^-8 at every T: a logit of size |s| moves by up to |s| · 2^-9, so the
    probabilities err by several times the bf16 rounding.
"""

import math

import pytest
import torch

from benchmark.harness.weights import fill_, seeded_generator
from benchmark.reference import clip_vision_transformer as REF
from embodied_clip_tpu_torch.models import encoders as E
from embodied_clip_tpu_torch.models.clip import CLIP_MODELS, CLIPViTVisual, image_size_of
from embodied_clip_tpu_torch.models.clip_text import CLIP_TEXT_CONFIGS
from embodied_clip_tpu_torch.models.clip_vit import CLIP_VIT_CONFIGS, VisionTransformer
from embodied_clip_tpu_torch.models.transformer import MultiHeadAttention, attention_core
from embodied_clip_tpu_torch.ops.kernels import attention_kernel as AK
from embodied_clip_tpu_torch.parity import cosine_distance
from embodied_clip_tpu_torch.utils.profiling import recorded

NAME = "ViT-L/14@336px"
SMALL = dict(patch_size=14, width=64, layers=2, num_heads=4, output_dim=32, image_size=56)
ROW_LIMIT, CORE_LIMIT = 2.0 ** -8, 2.0 ** -7


def test_config_is_openais_published_widths():
    """openai/CLIP `clip/clip.py` `_MODELS["ViT-L/14@336px"]` and `build_model`: width
    1,024, 24 blocks, 16 heads of 64, patch 14 at 336 px, output 768 (text tower 768 wide,
    12 blocks of 12 heads)."""
    assert CLIP_VIT_CONFIGS[NAME] == dict(patch_size=14, width=1024, layers=24, num_heads=16,
                                          output_dim=768, image_size=336)
    assert CLIP_TEXT_CONFIGS[NAME] == dict(width=768, layers=12, num_heads=12, output_dim=768)
    assert NAME in CLIP_MODELS and image_size_of(NAME) == 336
    assert E.ENCODER_SPECS["clip_vit_l14_336"] == E.EncoderSpec("clip", NAME)


def test_full_size_tower_takes_openais_visual_keys():
    """At full size (on the meta device): the port's tower holds exactly the release's
    `visual.*` keys and shapes, 304.3 M parameters, and the weight loader takes them."""
    with torch.device("meta"):
        port = CLIPViTVisual(NAME, torch.bfloat16)
        ref = REF.build({"model": dict(CLIP_VIT_CONFIGS[NAME], heads=16)})
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    assert (24 * 24 + 1, 1024) == want["positional_embedding"]
    n = sum(v.numel() for v in ref.state_dict().values())
    assert 304.2e6 < n < 304.4e6
    sd = E._module_state_dict(E.ENCODER_SPECS["clip_vit_l14_336"],
                              {f"visual.{k}": v for k, v in ref.state_dict().items()})
    assert set(sd) == set(want)


def _small_pair(seed: int):
    with torch.device("meta"):
        ref = REF.build({"model": dict(SMALL, heads=SMALL["num_heads"])})
    ref = fill_(ref.to_empty(device="cpu"), seeded_generator(seed, 1, "cpu")).eval()
    ports = {}
    for dtype in (torch.float32, torch.bfloat16):
        with torch.device("meta"):
            m = VisionTransformer(dtype=dtype, **SMALL)
        m = m.to_empty(device="cpu")
        m.load_state_dict(ref.state_dict())
        ports[dtype] = m.eval()
    return ref, ports


@pytest.mark.parametrize("seed", [0, 5])
def test_small_vit_of_the_same_structure_matches_the_reference(seed):
    torch.set_num_threads(4)
    ref, ports = _small_pair(seed)
    x = torch.randn(3, 3, 56, 56, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        want = ref.features(x)["clip_embed"]
        got = ports[torch.float32](x.permute(0, 2, 3, 1))
        bf16 = ports[torch.bfloat16](x.permute(0, 2, 3, 1))
    assert want.shape == (3, 32)
    torch.testing.assert_close(got, want, atol=5e-4, rtol=5e-4)
    assert cosine_distance(bf16, want) < 1e-3


def _qkv(n: int, t: int, heads: int, seed: int) -> torch.Tensor:
    """Seeded bf16 in-projection outputs: q and k of std 1.7 (logits of std ~2.9), v of
    unit scale."""
    gen = torch.Generator().manual_seed(seed)
    c = 64 * heads
    x = torch.randn(n, t, 3 * c, generator=gen)
    x[..., :2 * c] *= 1.7
    return x.to(torch.bfloat16)


def _exact(qkv, heads):
    n, t, c3 = qkv.shape
    q, k, v = (x.reshape(n, t, heads, 64).transpose(1, 2).double()
               for x in qkv.split(c3 // 3, dim=-1))
    out = ((q @ k.transpose(-1, -2)) / 8.0).softmax(dim=-1) @ v
    return out.transpose(1, 2).reshape(n, t, c3 // 3)


def _row_gap(a, b):
    a, b = a.double(), b.double()
    return float(((a - b).norm(dim=-1) / b.norm(dim=-1)).max())


@pytest.mark.parametrize("t,n,heads", [(577, 1, 4), (50, 4, 12), (17, 8, 4)])
def test_attention_plain_against_core_and_exact(t, n, heads):
    torch.set_num_threads(4)
    qkv = _qkv(n, t, heads, seed=t)
    exact = _exact(qkv, heads)
    plain = AK.attention_plain(qkv, heads)
    core = attention_core(*qkv.chunk(3, dim=-1), heads, torch.bfloat16)
    assert plain.dtype == torch.bfloat16 and plain.shape == (n, t, 64 * heads)
    assert _row_gap(plain, exact) <= ROW_LIMIT
    assert _row_gap(plain, core) <= CORE_LIMIT
    # The wrapper's CPU route is the plain version.
    assert torch.equal(AK.attention_bf16(qkv, heads), plain)
    # A lower precision is caught: the logits rounded to bf16 before the softmax.
    low = AK.attention_plain(qkv, heads, logits_dtype=torch.bfloat16)
    assert _row_gap(low, exact) > ROW_LIMIT


def test_issued_and_useful_macs():
    """The launch's tiles: 64-row warpgroup tiles; in the last key tile q·kᵀ over 16
    keys where 16 or fewer remain (else 64) and p·v in steps of 16."""
    c = 1024
    assert AK.useful_macs(128, 577, c) == 2 * 128 * 577 * 577 * c
    assert AK.issued_macs(1, 577, c) == 640 * (592 + 592) * c
    assert AK.issued_macs(1, 50, 768) == 64 * (64 + 64) * 768
    assert AK.issued_macs(1, 100, 64) == 128 * (128 + 64 + 48) * 64
    assert AK.issued_macs(2, 128, 64) == 2 * 128 * 256 * 64 == AK.useful_macs(2, 128, 64)
    for t in (1, 16, 17, 50, 577, 1000):
        assert AK.issued_macs(3, t, 256) >= AK.useful_macs(3, t, 256)
    pad = 1 - AK.useful_macs(1, 577, c) / AK.issued_macs(1, 577, c)
    assert 0.12 < pad < 0.125


def test_dispatch_keeps_attention_core_off_the_card():
    """The kernel takes CUDA bf16 unmasked heads of 64 only: on the CPU, in f32, or
    masked, `MultiHeadAttention` keeps `attention_core` (the JAX package's numbers)."""
    qkv = _qkv(2, 17, 2, seed=1)
    assert not AK.kernel_takes(qkv, 2)
    assert not AK.kernel_takes(qkv.float(), 2)
    mha = MultiHeadAttention(128, 2, torch.bfloat16)
    with torch.no_grad():
        for p in mha.parameters():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(3)) * 0.1)
        x = torch.randn(2, 17, 128).to(torch.bfloat16)
        q, k, v = torch.nn.functional.linear(x, mha.in_proj_weight, mha.in_proj_bias).chunk(3, -1)
        want = mha.out_proj(attention_core(q, k, v, 2, torch.bfloat16))
        assert torch.equal(mha(x), want)


def test_vit_spans_nest_under_the_trunk():
    from torch.profiler import ProfilerActivity, profile

    from embodied_clip_tpu_torch.parity import golden_frames

    enc = E.build_encoder("clip_vit_tiny", torch.float32, device="cpu")
    frames = golden_frames(2, 60, 60)
    enc.encode(frames)   # outside a session: nothing recorded
    with profile(activities=[ProfilerActivity.CPU]):
        enc.encode(frames)
    rec = recorded()
    by_id = {s.id: s for s in rec.spans}
    parent = {s.name: by_id[s.parent].name for s in rec.spans if s.parent is not None}
    assert {parent[k] for k in ("vit.embed", "vit.blocks", "vit.head")} == {"encode.trunk"}
    assert parent["attn.core"] == "vit.blocks"
    assert rec.by_name()["attn.core"].calls == CLIP_VIT_CONFIGS["ViTtiny"]["layers"]
    assert "attn.issued_macs" not in rec.counters   # no launch on the CPU
    assert math.isfinite(rec.by_name()["vit.blocks"].host_s)


def test_vit_counts_its_per_element_work():
    """Under a profiler session the tower counts the elements of every LayerNorm (ln_pre,
    ln_1 and ln_2 a block) and QuickGELU into `pw.elements`; on the CPU none goes through
    the launches, so `pw.fused_elements` is never counted (the metric
    `pointwise_fused_pct.encode` reads the two)."""
    from torch.profiler import ProfilerActivity, profile

    from embodied_clip_tpu_torch.parity import golden_frames

    cfg = CLIP_VIT_CONFIGS["ViTtiny"]
    enc = E.build_encoder("clip_vit_tiny", torch.bfloat16, device="cpu")
    frames = golden_frames(2, 60, 60)
    enc.encode(frames)   # outside a session: the next session starts a fresh store
    with profile(activities=[ProfilerActivity.CPU]):
        enc.encode(frames)
    counters = recorded().counters
    tokens = 2 * ((cfg["image_size"] // cfg["patch_size"]) ** 2 + 1)
    width, layers = cfg["width"], cfg["layers"]
    assert counters["pw.elements"] == tokens * width * (2 * layers + 1) + \
        tokens * 4 * width * layers
    assert "pw.fused_elements" not in counters
