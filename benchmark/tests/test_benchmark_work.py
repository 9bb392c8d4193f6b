"""The work counts against hand-worked numbers."""

import json

import pytest

from benchmark.harness.cell import REPO, module


def _config(name):
    return json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())


def test_clip_rn50_macs_per_frame():
    cfg = _config("clip_rn50_int8")
    trunk, heads, hw, c = module("work", "clip_modified_resnet").per_frame(
        cfg["model"], cfg["precision"])
    macs = {p: v / 2 for p, v in trunk.ops.items()}
    # Stem: 112^2 x (32x27 + 32x288 + 64x288) = 357.6 M; stem1 and stem2 in f32.
    stem = 112 ** 2 * (32 * 27 + 32 * 288 + 64 * 288)
    assert stem == pytest.approx(357.6e6, rel=1e-3)
    assert macs["f32"] == 112 ** 2 * (32 * 27 + 32 * 288)
    assert sum(macs.values()) - stem == pytest.approx(5.01e9, rel=2e-3)   # the stages
    assert sum(heads.ops.values()) / 2 == pytest.approx(0.426e9, rel=2e-3)
    assert (sum(macs.values()) + sum(heads.ops.values()) / 2) == pytest.approx(5.793e9,
                                                                                 rel=1e-3)
    assert (hw, c) == (7, 2048)


def test_resnet50_macs_per_frame():
    cfg = _config("imagenet_rn50_bf16")
    trunk, hw, c = module("work", "torchvision_resnet").per_frame(cfg["model"],
                                                                   cfg["precision"])
    # torchvision's ResNet-50 without fc: 4.09 GMAC (4.11 with its 2 M-MAC fc).
    assert sum(trunk.ops.values()) / 2 == pytest.approx(4.0871e9, rel=1e-4)
    assert set(trunk.ops) == {"bf16"} and (hw, c) == (7, 2048)


@pytest.mark.parametrize("name", ["clip_rn50_int8", "imagenet_rn50_bf16"])
def test_preprocess_bytes_at_batch_128(name):
    cfg = _config(name)
    w = module("work", cfg["work"]).work(cfg, 128, (300, 300))
    # uint8 300x300x3 in, bf16 224x224x3 out: 34.56 MB + 38.54 MB.
    assert w["preprocess"]["bytes"] == 128 * (300 * 300 * 3 + 224 * 224 * 3 * 2)
    assert w["preprocess"]["bytes"] == pytest.approx(73.1e6, rel=1e-3)
    trunk = f"{cfg['precision']['stage_convs']}_trunk"
    assert set(w) >= {"preprocess", trunk, "model"}


def test_vit_l14_336_macs_per_frame():
    # openai/CLIP's ViT-L/14@336px: width 1,024, 24 blocks, 16 heads, patch 14 at 336 px
    # (577 tokens), output 768; bf16 denses, f32 attention products and projection.
    model = {"patch_size": 14, "width": 1024, "layers": 24, "heads": 16, "output_dim": 768,
             "image_size": 336}
    precision = {"patch_embed": "bf16", "denses": "bf16", "attention": "f32",
                 "activations": "bf16", "proj": "f32", "outputs": "bf16"}
    vit = module("work", "clip_vision_transformer")
    trunk, attention, tokens = vit.per_frame(model, precision)
    assert tokens == 577
    gmac = sum(trunk.ops.values()) / 2e9
    assert 190 <= gmac <= 192 and gmac == pytest.approx(190.96, abs=0.005)
    assert attention.ops["f32"] / 2 == 24 * 2 * 577 ** 2 * 1024   # q.k^T and p.v
    w = vit.work({"model": model, "precision": precision}, 128, (300, 300))
    # A fused attention launch reads q, k, v and writes its output once: 14.5 GB a batch.
    assert w["attention"]["bytes"] == 128 * 24 * 4 * 577 * 1024 * 2
    assert w["model"] == w["vit_trunk"]
