"""The registry's policies across packages, ObjectNav names: for every registered
RoboTHOR and zero-shot experiment (tiny overrides), the JAX package's
`_build_policy(env)` parameters convert (`models/convert.from_flax_policy_params`,
`from_flax_allenact_params`) and load strictly into the port's `_build_policy(env)`,
and one policy step on the same observations agrees within test_torch_policy.py's
tolerance (atol 1e-5). The habitat and rearrangement names are in
test_torch_registry_policies_habitat.py. Also the int8 calibration frames
(`_calibration_frames`) against the JAX package's recipe.
"""

import numpy as np
import pytest
import torch

from embodied_clip_tpu.parity import golden_frames as jax_golden_frames

from embodied_clip_tpu_torch.config import experiments as pexp
from torch_registry_cases import check_policy_agrees, one_thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_thread()

NAMES = [n for n in pexp.list_experiments() if "robothor" in n]


@pytest.mark.parametrize("name", NAMES)
def test_registry_policy_loads_jax_params_and_agrees(name):
    check_policy_agrees(name)


def test_allenact_policy_loads_jax_params():
    """policy_arch=allenact on a conv-map encoder: the JAX package's released-model
    architecture converts into the port's."""
    check_policy_agrees("objectnav_robothor_rgb_clipresnet50gru_ddppo", "allenact")


def _jax_tiling(frames16, v):
    """The JAX package's top-up (`config/rl_experiments.py:229-236`) of env frames."""
    h, w = frames16.shape[1:3]
    reps = (max(1, -(-h // v.shape[1])), max(1, -(-w // v.shape[2])))
    return np.tile(v, (1, reps[0], reps[1], 1))[:, :h, :w]


def test_calibration_frames():
    name = "objectnav_robothor_rgb_clipresnet50gru_ddppo"
    p = pexp.get_experiment(name, ["device=cpu"])
    frames = p._calibration_frames()
    golden = jax_golden_frames(n=16)
    assert frames.shape == (24, 300, 300, 3) and frames.dtype == np.uint8
    np.testing.assert_array_equal(frames[:16], golden)
    _, obs = p._build_fake_env().reset(torch.Generator().manual_seed(0), 8)
    np.testing.assert_array_equal(frames[16:], _jax_tiling(golden, obs["visual"].numpy()))
    for over in (["backend=thor"], ["encoder=none"], ["task=rearrange"]):
        q = pexp.get_experiment(name, ["device=cpu"] + over)
        np.testing.assert_array_equal(q._calibration_frames(), golden)
