"""A CLIP ViT through the harness from data alone: the plain reference
(`reference/clip_vision_transformer.py`) against the port's float32 ViT on the same
weights (from frames: `test_benchmark_reference.py`), the work counts
(`work/clip_vision_transformer.py`), and whole runs of `drivers/encode.py` on a cell
made here from a configuration dict and a traffic dict, with no harness file written for
it.

Tolerances, as cosine distances per frame (float64):
- the module on one input: 1e-11. The port and the reference compute the same float32
  arithmetic in another order (the patch embed as a matmul, not a conv): relative gaps
  of about 5e-7, cosine distances of about 1e-13, as float32 against float64 gives;
- from uint8 frames: 1e-8, as the ResNet references are held. The port's float32 resize
  and the reference's can round a pixel's value one uint8 step apart where it lies on a
  tie (PIL's rounding, which both keep), and that moves a ViTtiny embedding by up to
  ~1e-4 relative, ~5e-9 in cosine distance (seed 3 below). The bf16 program reads 1.5e-5
  to 4.2e-5 on these frames, a thousand times more.
"""

import math

import pytest
import torch

from benchmark.harness.cell import Cell, load_layers, module
from benchmark.harness.compare import cosine_distances
from benchmark.harness.faults import FAULTS
from benchmark.harness.frames import golden_frames
from benchmark.harness.program import build_encoder
from benchmark.harness.runner import run
from benchmark.harness.weights import fill_, seeded_generator
from benchmark.reference import clip_vision_transformer, preprocess
from benchmark.tests.conftest import SEED, VIT_TINY

MODULE_TOL, FRAMES_TOL = 1e-11, 1e-8

CONFIG = {
    "name": "clip_vit_tiny_f32",
    "source": "https://github.com/openai/CLIP/blob/main/clip/model.py",
    "reference": "clip_vision_transformer",
    "work": "clip_vision_transformer",
    "family": "clip",
    "producer": "embodied_clip_tpu_torch.models.clip_vit:VisionTransformer.forward",
    "model": VIT_TINY,
    "precision": {"patch_embed": "f32", "denses": "f32", "attention": "f32",
                  "activations": "f32", "proj": "f32", "outputs": "f32"},
    "calibration_frames": 4,
    "calibration_hw": [60, 60],
    "program": {"encoder": "clip_vit_tiny", "dtype": "float32"},
    "control": {"dtype": "bfloat16"},
}
TRAFFIC = {"driver": "encode", "batch": 4, "frame_hw": [60, 60], "layout": "flat",
           "pool": 2, "resident": "device", "sync_each": False, "warmup_units": 1,
           "trace_skip": 1, "trace_units": 2}
END_TO_END = [{"name": "encode_fps", "unit": "frames/s"}, {"name": "setup_s", "unit": "s"}]
PER_LAYER = [{"name": "mfu.encode", "unit": "%"},
             {"name": "device_idle_pct.encode", "unit": "%"},
             {"name": "k6_roofline", "unit": "%"}]


def _cell():
    return Cell(name="clip_vit_tiny_f32.encode_test", config=dict(CONFIG),
                traffic=dict(TRAFFIC), limits={"cos.clip_embed": FRAMES_TOL},
                end_to_end=END_TO_END, per_layer=PER_LAYER, layers=load_layers())


def _reference(seed: int):
    with torch.device("meta"):
        ref = clip_vision_transformer.build({"model": VIT_TINY})
    return fill_(ref.to_empty(device="cpu"), seeded_generator(seed, 1, "cpu")).eval()


@pytest.mark.parametrize("seed", [0, 3])
def test_module_agrees_and_frames_separate_bf16(seed):
    torch.set_num_threads(4)
    ref = _reference(seed)
    frames = golden_frames(8, 300, 300, seeded_generator(seed, 3, "cpu"))
    x = preprocess.preprocess(frames, VIT_TINY["image_size"], "clip")
    enc = build_encoder(CONFIG["program"], ref.state_dict(), None, "cpu")
    with torch.no_grad():
        want = ref.features(x)
        same_input = enc.module(x.permute(0, 2, 3, 1).contiguous())["embed"]
    got = enc.encode(frames)
    assert set(got) == set(want) == {"clip_embed"}
    assert got["clip_embed"].shape == want["clip_embed"].shape == (8, 16)
    assert float(cosine_distances(same_input, want["clip_embed"]).max()) < MODULE_TOL
    assert float(cosine_distances(got["clip_embed"], want["clip_embed"]).max()) < FRAMES_TOL
    bf16 = build_encoder(dict(CONFIG["program"], dtype="bfloat16"), ref.state_dict(), None,
                         "cpu").encode(frames)
    assert float(cosine_distances(bf16["clip_embed"], want["clip_embed"]).max()) > \
        100 * FRAMES_TOL


def test_encode_loop_runs_a_vit_cell_from_data():
    torch.set_num_threads(4)
    result, checks = run(_cell(), SEED, 0.2, False, "cpu")
    assert result["correct"], checks
    assert math.isfinite(checks["cos.clip_embed"]["value"])
    assert checks["cos.clip_embed"]["value"] <= FRAMES_TOL
    assert set(result["metrics"]) == {"encode_fps", "setup_s"}
    assert result["attempted"] >= TRAFFIC["pool"]


def test_traced_vit_run_reads_its_work():
    torch.set_num_threads(4)
    cell = _cell()
    result, checks = run(cell, SEED, 0.2, True, "cpu")
    assert result["correct"], checks
    # The model's work reaches the readers; a ResNet launch kind reads nothing here.
    assert math.isfinite(result["metrics"]["mfu.encode"]["value"])
    assert result["metrics"]["mfu.encode"]["value"] > 0
    assert "k6_roofline" not in result["metrics"]


@pytest.mark.parametrize("fault", ["altered_answer", "half_batch"])
def test_vit_faults_are_not_correct(fault):
    torch.set_num_threads(4)
    cell = _cell()
    with FAULTS[fault](cell):
        result, checks = run(cell, SEED, 0.2, False, "cpu")
    assert not result["correct"], checks


def test_vit_control_is_not_correct():
    torch.set_num_threads(4)
    result, checks = run(_cell(), SEED, 0.2, False, "cpu", control=True)
    assert not result["correct"], checks


def test_vit_work_counts_at_test_size():
    w = module("work", "clip_vision_transformer").work(CONFIG, 4, (60, 60))
    assert set(w) == {"preprocess", "vit_trunk", "attention", "model"}
    tokens, c = (64 // 16) ** 2 + 1, 32
    macs = 16 * 16 * 3 * c * 16 + 2 * (12 * tokens * c * c + 2 * tokens * tokens * c) + c * 16
    assert w["model"]["ops"] == {"f32": 4 * 2.0 * macs}
    assert w["attention"]["ops"] == {"f32": 4 * 2 * 2.0 * 2 * tokens * tokens * c}
    assert w["attention"]["bytes"] == 4 * 2 * 4 * tokens * c * 4
