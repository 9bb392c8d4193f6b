"""Every registered RL experiment trains through the port's `train()` as registered
(tiny overrides, the fake backend on the CPU): the port's version of
tests/test_registry_trains.py:25-39. Encoder-bearing configs swap to the smoke-scale
CLIP trunk, so the frozen preprocess → encode → policy path still runs inside the
rollout. One more case trains with the int8 trunk and checks that it was calibrated on
`_calibration_frames()`.
"""

import glob
import os

import numpy as np
import pytest

from embodied_clip_tpu_torch.config.experiments import list_experiments
from torch_registry_cases import one_thread, port_experiment


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_thread()

RL_NAMES = [n for n in list_experiments() if not n.startswith("probe_")]


@pytest.mark.parametrize("name", RL_NAMES)
def test_registered_experiment_trains(name, tmp_path):
    exp = port_experiment(name)
    out = exp.train(output_dir=str(tmp_path))
    assert out["env_steps"] >= 64, (name, out)
    assert np.isfinite(out["loss"]), (name, out)
    # throughput is a logged trainer metric on both backends
    assert out.get("env_steps_per_s", 0) > 0, (name, out)
    assert glob.glob(os.path.join(str(tmp_path), name, "exp__steps_*"))


def test_int8_experiment_calibrates_on_its_frames(tmp_path, monkeypatch):
    from embodied_clip_tpu_torch.models import encoders

    seen = []
    quantize = encoders.FrozenEncoder.quantize

    def spy(self, frames):
        seen.append(np.array(frames))
        return quantize(self, frames)

    monkeypatch.setattr(encoders.FrozenEncoder, "quantize", spy)
    exp = port_experiment("objectnav_robothor_rgb_clipresnet50gru_ddppo",
                          encoder="clip_rn_tiny", encoder_dtype="int8")
    out = exp.train(output_dir=str(tmp_path))
    assert out["env_steps"] >= 64 and np.isfinite(out["loss"])
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0], exp._calibration_frames())
    assert seen[0].shape == (24, 300, 300, 3)
    enc = exp._encode_fn()
    assert type(enc.encoder).__name__ == "_QuantizedCLIPEncoder" and enc.key == "clip_conv"


def test_vit_encoder_routes_flat_policy(tmp_path):
    """`encoder=clip_vit_*` trains: ViT encoders emit only `clip_embed`, which routes
    through the flat-visual policy path (the port's version of
    tests/test_rl_extras.py:451-475)."""
    import torch

    exp = port_experiment("objectnav_robothor_rgb_clipresnet50gru_ddppo",
                          total_env_steps=32, encoder="clip_vit_tiny",
                          encoder_dtype="float32")
    assert not exp._encoder_emits_map()
    enc = exp._encode_fn()
    assert enc.key == "clip_embed"
    pol = exp._make_policy(6, frame_obs=True, visual_shape=enc.feature_shape)
    assert pol.visual_is_map is False and pol.scratch_cnn is False
    vis = enc(torch.zeros((2, 64, 64, 3), dtype=torch.uint8))
    assert vis.ndim == 2
    out = exp.train(output_dir=str(tmp_path))
    assert out["env_steps"] >= 32 and np.isfinite(out["loss"])
