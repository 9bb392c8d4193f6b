"""The plain references against the port's float32 encoders on the same weights and
frames (this test may import both; the references themselves import nothing of the
port)."""

import pytest
import torch

from benchmark.harness.compare import cosine_distances
from benchmark.harness.frames import golden_frames
from benchmark.harness.program import build_encoder
from benchmark.harness.weights import fill_, seeded_generator
from benchmark.reference import (
    clip_modified_resnet,
    clip_vision_transformer,
    preprocess,
    torchvision_resnet,
)
from benchmark.tests.conftest import VIT_TINY

CASES = {
    "clip_rn_tiny": (clip_modified_resnet, "clip", {"stage_sizes": [1, 1, 1, 1], "width": 8,
                     "heads": 4, "output_dim": 16, "image_size": 128}, 4),
    "clip_rn50": (clip_modified_resnet, "clip", {"stage_sizes": [3, 4, 6, 3], "width": 64,
                  "heads": 32, "output_dim": 1024, "image_size": 224}, 1),
    "imagenet_rn50": (torchvision_resnet, "imagenet", {"stage_sizes": [3, 4, 6, 3],
                      "width": 64, "image_size": 224}, 1),
    "clip_vit_tiny": (clip_vision_transformer, "clip", VIT_TINY, 8),
}


@pytest.mark.parametrize("encoder", list(CASES))
def test_reference_matches_port_f32(encoder):
    torch.set_num_threads(4)
    ref_mod, family, model, n = CASES[encoder]
    with torch.device("meta"):
        ref = ref_mod.build({"model": model})
    ref = fill_(ref.to_empty(device="cpu"), seeded_generator(11, 1, "cpu")).eval()
    frames = golden_frames(n, 300, 300, seeded_generator(11, 3, "cpu"))
    enc = build_encoder({"encoder": encoder, "dtype": "float32"}, ref.state_dict(), None,
                        "cpu")
    with torch.no_grad():
        want = ref.features(preprocess.preprocess(frames, model["image_size"], family))
    got = enc.encode(frames)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape
        assert float(cosine_distances(got[k], want[k]).max()) < 1e-8, k


def test_preprocess_flat_layout_and_upscale():
    frames = golden_frames(2, 56, 56, seeded_generator(3, 3, "cpu"))
    a = preprocess.preprocess(frames, 224, "clip")
    b = preprocess.preprocess(frames.reshape(2, 56, 56 * 3), 224, "clip")
    assert a.shape == (2, 3, 224, 224) and torch.equal(a, b)
    w = preprocess.resample_weights(300, 224)
    assert w.shape == (224, 300) and abs(w.sum(1) - 1).max() < 1e-6
