"""The PyTorch port's frozen encoder end to end vs the JAX package, on the CPU.

Same weights (carried across by `from_flax_variables` / `from_flax_resnet_variables`)
and the same uint8 frames go through both packages' encoders: per-key cosine distance
≤1e-4 in f32 and ≤1e-3 in bf16 (the BASELINE.json north star), for `clip_rn_tiny` and
the full-size torchvision `imagenet_rn18` / `imagenet_rn50`. The port's folded bf16
encoders run their bottleneck trunks through K6/K7 (the plain versions, on the CPU).
Also: the port's entry points stay off the CPU unless asked, and the package imports
no JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_clip_tpu.models.encoders import build_encoder as jax_build_encoder

from embodied_clip_tpu_torch.models.convert import (
    from_flax_resnet_variables,
    from_flax_variables,
)
from embodied_clip_tpu_torch.models.encoders import ENCODER_SPECS, EncoderSpec, build_encoder
from embodied_clip_tpu_torch.parity import cosine_distance, golden_frames

import torch_oracle as O

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"clip_conv": (4, 4, 256), "clip_avgpool": (256,), "clip_attnpool": (16,)}


@pytest.fixture(scope="module")
def frames():
    return golden_frames(2)


@pytest.mark.parametrize("dtype,fold,limit", [
    ("float32", False, 1e-4), ("float32", True, 1e-4),
    ("bfloat16", False, 1e-3), ("bfloat16", True, 1e-3)])
def test_encode_matches_jax(frames, dtype, fold, limit):
    jenc = jax_build_encoder("clip_rn_tiny", dtype=getattr(jnp, dtype))
    enc = build_encoder("clip_rn_tiny", dtype=getattr(torch, dtype), device="cpu")
    enc.load_torch_state_dict(from_flax_variables(jax.tree.map(np.asarray, jenc.variables)))
    if fold:
        jenc, enc = jenc.fold_bn(), enc.fold_bn()
    ref = jenc.encode(frames)
    got = enc.encode(frames)
    assert set(got) == set(ref) == set(KEYS)
    for key, shape in KEYS.items():
        assert tuple(got[key].shape) == (2, *shape) == ref[key].shape
        assert got[key].dtype == getattr(torch, dtype)
        assert torch.isfinite(got[key].float()).all()
        assert cosine_distance(got[key], np.asarray(ref[key], np.float32)) <= limit, key


@pytest.mark.parametrize("name,width", [("imagenet_rn18", 512), ("imagenet_rn50", 2048)])
@pytest.mark.parametrize("dtype,fold,limit", [("float32", False, 1e-4),
                                              ("bfloat16", True, 1e-3)])
def test_imagenet_encode_matches_jax(frames, name, width, dtype, fold, limit):
    jenc = jax_build_encoder(name, dtype=getattr(jnp, dtype))
    enc = build_encoder(name, dtype=getattr(torch, dtype), device="cpu")
    sd = from_flax_resnet_variables(jax.tree.map(np.asarray, jenc.variables))
    enc.load_torch_state_dict({**sd, "fc.weight": torch.zeros(1000, width)})  # fc dropped
    if fold:
        jenc, enc = jenc.fold_bn(), enc.fold_bn()
        assert enc.module.runs_fused_plan
    ref = jenc.encode(frames)
    got = enc.encode(frames)
    shapes = {"imagenet_conv": (2, 7, 7, width), "imagenet_avgpool": (2, width)}
    assert set(got) == set(ref) == set(shapes)
    for key, shape in shapes.items():
        assert tuple(got[key].shape) == shape == ref[key].shape
        assert got[key].dtype == getattr(torch, dtype)
        assert cosine_distance(got[key], np.asarray(ref[key], np.float32)) <= limit, key


def test_fold_bn_keeps_the_cudnn_route_reachable(frames):
    """The cuDNN route is what an unfolded or f32 trunk runs, with no switch: the
    unfolded bf16 encoder stays on it and the folded one takes K6/K7 (their plain
    versions on the CPU), within 1e-3 of the unfolded f32 encoder on every key.
    `fold_bn()` of a folded, a quantized or a ViT encoder returns it as it is."""
    enc = build_encoder("clip_rn_tiny", dtype=torch.bfloat16, device="cpu")
    folded = enc.fold_bn()
    assert folded is not enc and folded.module.runs_fused_plan
    assert not enc.module.runs_fused_plan
    assert folded.fold_bn() is folded
    quantized = folded.quantize(golden_frames(4))
    assert quantized.fold_bn() is quantized
    vit = build_encoder("clip_vit_tiny", dtype=torch.bfloat16, device="cpu")
    assert vit.fold_bn() is vit
    ref = build_encoder("clip_rn_tiny", device="cpu").encode(frames)
    got = folded.encode(frames)
    for key in KEYS:
        assert cosine_distance(got[key], ref[key]) <= 1e-3, key


def test_encode_layouts_agree(frames):
    enc = build_encoder("clip_rn_tiny", device="cpu").fold_bn()
    nhwc = enc.encode(frames)
    flat = enc.encode(torch.from_numpy(frames.reshape(2, 300, 900)))
    for key in KEYS:
        assert torch.equal(nhwc[key], flat[key])
    assert not torch.is_inference_mode_enabled()


def test_torch_checkpoint_with_visual_prefix(tmp_path):
    """An openai-named full-model checkpoint on disk loads through
    build_encoder(torch_checkpoint=...) and reproduces the oracle's features."""
    torch.manual_seed(8)
    oracle = O.ModifiedResNetOracle((1, 1, 1, 1), 8, 4, 16, 128).eval()
    path = str(tmp_path / "rn_tiny.pt")
    torch.save({f"visual.{k}": v for k, v in oracle.state_dict().items()}, path)
    enc = build_encoder("clip_rn_tiny", torch_checkpoint=path, device="cpu")
    x = torch.from_numpy(np.random.RandomState(9).randn(1, 128, 128, 3).astype(np.float32))
    with torch.no_grad():
        got = enc.module(x)["embed"]
        ref = oracle(x.permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=5e-4, rtol=5e-4)


def test_unported_paths_raise():
    """Every encoder of the JAX package is ported, the ViTs and their int8 tower
    included, and the port adds one, `clip_vit_l14_336` (ViT-L/14@336px, which the JAX
    package does not list); a name the port does not know still raises, pointing at the
    roadmap."""
    from embodied_clip_tpu.models.encoders import ENCODER_SPECS as JAX_SPECS

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_encoder("clip_vit_l14", device="cpu")
    assert set(ENCODER_SPECS) - set(JAX_SPECS) == {"clip_vit_l14_336"}
    assert set(JAX_SPECS) <= set(ENCODER_SPECS)
    assert all(EncoderSpec(s.family, s.arch) == ENCODER_SPECS[n] for n, s in JAX_SPECS.items())


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_encoder("clip_rn_tiny")


def test_package_imports_no_jax():
    code = ("import sys, pkgutil, importlib, embodied_clip_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'embodied_clip_tpu')]\n"
            "assert not bad, bad\n"
            "print('clean', len([m for m in sys.modules if m.startswith(p.__name__)]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
