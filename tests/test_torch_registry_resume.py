"""The registry's step checkpoints, resume and evaluation on the fake backend (the
port's versions of tests/test_host_envs.py:313-362, tests/test_rl_extras.py:378-422 and
the fake path of `evaluate`), on the CPU."""

import dataclasses as dc
import glob
import json
import os

import numpy as np
import pytest
import torch

from embodied_clip_tpu_torch.config.rl_experiments import NavRLExperiment
from embodied_clip_tpu_torch.constants import ZEROSHOT_UNSEEN_OBJECTS
from embodied_clip_tpu_torch.utils.checkpoint import restore_params, restore_pytree
from torch_registry_cases import one_thread, port_experiment


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_thread()

# The keys of the JAX package's `evaluate` result (config/rl_experiments.py:732-745,
# one process).
OVERALL_KEYS = {"success", "spl", "episodes", "episodes_requested", "metrics_file",
                "per_object_type"}


def test_experiment_resume_from_latest(tmp_path):
    """Resume-on-restart: a second train() continues from the saved env-step count."""
    kw = dict(name="resume_smoke", backend="fake", encoder=None,
              total_env_steps=256, rollout_len=8, env_batch=8, hidden=16,
              ckpt_every_steps=128, device="cpu")
    out1 = NavRLExperiment(**kw).train(output_dir=str(tmp_path))
    assert out1["env_steps"] >= 256
    names = sorted(os.listdir(tmp_path / "resume_smoke"))
    assert names == ["exp__steps_000000000128.pt", "exp__steps_000000000256.pt"]
    # Second run: already past total_env_steps -> trains 0 new iterations but
    # restores and re-saves cleanly.
    exp2 = NavRLExperiment(**kw)
    out2 = exp2.train(output_dir=str(tmp_path))
    assert out2["env_steps"] >= 256
    saved = torch.load(tmp_path / "resume_smoke" / names[-1], weights_only=True)
    for k, v in exp2._last_policy.state_dict().items():
        assert torch.equal(v, saved["params"][k]), k
    assert int(saved["opt_state"]["count"]) == 256 // 64 * 4  # iterations × epochs


def test_resume_bitwise_matches_uninterrupted(tmp_path):
    """Checkpoints hold the whole train state — params, optimizer state (Adam moments
    + update count), the act carry (env state, obs, hidden) and the generator — so a
    run stopped at a checkpoint and resumed is bitwise identical to an uninterrupted
    one."""
    kw = dict(name="resume_bitwise", backend="fake", encoder=None,
              total_env_steps=512, rollout_len=8, env_batch=8, hidden=16,
              ckpt_every_steps=256, device="cpu")
    full = NavRLExperiment(**kw)
    full.train(output_dir=str(tmp_path / "full"))
    # Stop at 256 steps (train to the halfway checkpoint) …
    NavRLExperiment(**{**kw, "total_env_steps": 256}).train(str(tmp_path / "split"))
    # … then resume from the latest checkpoint and finish.
    resumed = NavRLExperiment(**kw)
    out = resumed.train(output_dir=str(tmp_path / "split"))
    assert out["env_steps"] == 512
    want, got = full._last_policy.state_dict(), resumed._last_policy.state_dict()
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    # and the stored train states agree leaf for leaf
    a = restore_pytree(str(tmp_path / "full" / "resume_bitwise" / "exp__steps_000000000512.pt"))
    b = restore_pytree(str(tmp_path / "split" / "resume_bitwise" / "exp__steps_000000000512.pt"))
    for (ka, va), (kb, vb) in zip(_leaves(a), _leaves(b)):
        assert ka == kb and torch.equal(va, vb), ka


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_fake_eval_writes_metrics_json(tmp_path):
    exp = port_experiment("objectnav_robothor_rgb_clipresnet50gru_ddppo", eval_episodes=16)
    exp.train(output_dir=str(tmp_path))
    out = exp.evaluate(output_dir=str(tmp_path))
    assert set(out) == OVERALL_KEYS
    assert out["episodes"] == out["episodes_requested"] == 16
    path = os.path.join(str(tmp_path), exp.name, "metrics.json")
    assert out["metrics_file"] == path
    with open(path) as f:
        eps = json.load(f)[0]["tasks"]
    assert len(eps) == 16
    assert set(eps[0]) == {"success", "spl", "ep_length", "task_info"}
    for t, v in out["per_object_type"].items():
        mine = [e for e in eps if e["task_info"]["object_type"] == t]
        assert abs(v["success"] - np.mean([e["success"] for e in mine])) < 1e-12
    # from the step checkpoint alone, in a fresh experiment: the same records
    ckpt = sorted(glob.glob(os.path.join(str(tmp_path), exp.name, "exp__steps_*")))[-1]
    fresh = port_experiment("objectnav_robothor_rgb_clipresnet50gru_ddppo", eval_episodes=16)
    out2 = fresh.evaluate(output_dir=str(tmp_path / "again"), ckpt=ckpt)
    assert out2["per_object_type"] == out["per_object_type"]


def test_zeroshot_eval_reports_unseen_classes(tmp_path):
    from embodied_clip_tpu_torch.zeroshot import seen_unseen_class_ids

    exp = port_experiment("zeroshot_objectnav_robothor_rgb_clipresnet50gru_ddppo",
                          eval_episodes=64)
    exp.train(output_dir=str(tmp_path))
    # training drew only the seen classes
    seen, _ = seen_unseen_class_ids()
    assert set(exp._last_env.inner.class_set) == set(seen)
    out = exp.evaluate(output_dir=str(tmp_path))
    assert out["episodes"] == 64
    unseen = set(out["per_object_type"]) & set(ZEROSHOT_UNSEEN_OBJECTS)
    assert unseen, out["per_object_type"]


def test_fake_trained_checkpoint_transfers_to_thor_backend_policy(tmp_path):
    """Fake and THOR ObjectNav share the 6-action space: a checkpoint trained on the
    fake backend restores into the policy a thor-backend learner builds, parameter for
    parameter."""
    from embodied_clip_tpu_torch.constants import OBJECTNAV_ACTIONS
    from embodied_clip_tpu_torch.envs.gridworld import ACTIONS as GRID_ACTIONS

    assert GRID_ACTIONS == OBJECTNAV_ACTIONS  # names AND indices
    exp = port_experiment("objectnav_robothor_rgb_clipresnet50gru_ddppo",
                          total_env_steps=32, ckpt_every_steps=32)
    exp.train(output_dir=str(tmp_path))
    ckpts = sorted(glob.glob(os.path.join(str(tmp_path), exp.name, "exp_*")))
    assert ckpts, "train wrote no step checkpoint"
    saved = restore_pytree(ckpts[-1])["params"]
    thor = dc.replace(exp, backend="thor")
    policy, num_actions = thor._host_policy((300, 300, 3), thor._encode_fn())
    assert num_actions == 6
    template = policy.state_dict()
    assert {k: tuple(v.shape) for k, v in template.items()} == \
        {k: tuple(v.shape) for k, v in saved.items()}
    restored = restore_params(ckpts[-1], template)
    policy.load_state_dict(restored, strict=True)
    for k, v in policy.state_dict().items():
        assert torch.equal(v, saved[k]), k
