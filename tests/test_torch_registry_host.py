"""The registry on the host backends, on the CPU: `hostgrid` training with step
checkpoints, checkpoint evaluation ON THE SIMULATOR (the scripted THOR controller on
the val scenes; hostgrid with 3 workers), and two gloo processes × 2 workers training
what one process × 4 workers trains. The port's versions of
tests/test_host_envs.py:300-311, tests/test_host_eval.py and
tests/test_multiprocess_ddppo.py."""

import dataclasses as dc
import functools
import glob
import json
import os

import numpy as np
import pytest
import torch

from embodied_clip_tpu_torch.config.rl_experiments import NavRLExperiment
from embodied_clip_tpu_torch.parallel.dryrun import run_ranks
from torch_registry_cases import (
    one_thread,
    SentinelController,
    mp_equiv_rank,
    port_experiment,
    resume_rank,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_thread()

NAME = "objectnav_robothor_rgb_clipresnet50gru_ddppo"


def test_hostgrid_backend_experiment_trains(tmp_path):
    """Full host-backend path: VectorEnv pool -> HostPPOLearner -> checkpoints."""
    exp = NavRLExperiment(
        name="hostgrid_smoke", backend="hostgrid", encoder=None,
        total_env_steps=64, rollout_len=8, hidden=32, num_workers=2,
        ckpt_every_steps=10 ** 9, device="cpu")
    out = exp.train(output_dir=str(tmp_path))
    assert out["env_steps"] >= 64
    assert np.isfinite(out["loss"])
    assert glob.glob(str(tmp_path / "hostgrid_smoke" / "exp__steps_*"))


def test_thor_backend_eval_runs_on_simulator(tmp_path):
    """`evaluate` with backend=thor runs the checkpoint ON THE SIMULATOR, on the val
    scenes — never silently on the fake gridworld."""
    exp = port_experiment(NAME, total_env_steps=32, ckpt_every_steps=32)
    exp.train(output_dir=str(tmp_path))
    ckpt = sorted(glob.glob(os.path.join(str(tmp_path), exp.name, "exp_*")))[-1]
    sentinel = str(tmp_path / "sentinel.txt")
    exp2 = dc.replace(exp, backend="thor",
                      controller_factory=functools.partial(SentinelController, sentinel),
                      num_workers=2, eval_episodes=4, max_episode_steps=25)
    out = exp2.evaluate(output_dir=str(tmp_path / "eval"), ckpt=ckpt)

    assert os.path.exists(sentinel), \
        "no simulator was instantiated — eval ran on the fake gridworld"
    scenes = set(open(sentinel).read().split()) - {"FakeScene_1"}  # the constructor's
    assert scenes and all(s.startswith("FloorPlan_Val") for s in scenes), scenes
    assert out["episodes"] == 4 and out["episodes_requested"] == 4
    assert 0.0 <= out["success"] <= 1.0
    with open(os.path.join(str(tmp_path / "eval"), exp2.name, "metrics.json")) as f:
        eps = json.load(f)[0]["tasks"]
    assert len(eps) == 4
    # goal classes come from the fixture scene's object types (the THOR adapter's
    # candidate set), so the records came from the simulator
    types = {e["task_info"]["object_type"] for e in eps}
    assert types <= {"Mug", "Laptop", "Apple"}, types
    assert all(e["ep_length"] > 0 for e in eps)


def test_hostgrid_backend_eval_delivers_episodes(tmp_path):
    exp = dc.replace(port_experiment(NAME), backend="hostgrid", encoder=None,
                     num_workers=3, total_env_steps=24, rollout_len=4, hidden=32,
                     ckpt_every_steps=24, max_episode_steps=20)
    exp.train(output_dir=str(tmp_path / "hg_train"))
    ckpts = sorted(glob.glob(os.path.join(str(tmp_path / "hg_train"), exp.name, "exp_*")))
    assert ckpts
    out = dc.replace(exp, eval_episodes=6).evaluate(
        output_dir=str(tmp_path / "eval_hg"), ckpt=ckpts[-1])
    assert out["episodes"] == 6
    assert np.isfinite(out["spl"])


def test_two_processes_train_what_one_process_trains(tmp_path):
    """Two gloo processes × 2 hostgrid workers train the weights of one process × 4
    workers (tests/test_multiprocess_ddppo.py's tolerance: rtol 2e-4, atol 2e-5); the
    sharded evaluation merges both processes' episodes."""
    (sd0, out0, ev0), (sd1, _, ev1) = run_ranks(
        2, mp_equiv_rank, 2, str(tmp_path / "two"), True, timeout=240)
    sd, out, _ = mp_equiv_rank(4, str(tmp_path / "one"), False)
    assert out0["env_steps"] == out["env_steps"] == 64
    for k in sd:
        np.testing.assert_array_equal(sd0[k], sd1[k])
        np.testing.assert_allclose(sd0[k], sd[k], rtol=2e-4, atol=2e-5, err_msg=k)
    assert ev0["episodes"] == ev1["episodes"] == 8
    assert ev0["episodes_local"] == ev1["episodes_local"] == 4
    assert ev0["metrics_file"] and ev1["metrics_file"] is None
    assert os.path.exists(tmp_path / "two" / "mp_equiv" / "metrics.json")


def test_two_process_fake_backend_resume_is_bitwise(tmp_path):
    """In a 2-process group each rank's act carry and generator go into rank 0's step
    checkpoint, and each rank restores its own: the resumed run equals the
    uninterrupted one bit for bit, on both ranks."""
    (full0, res0, steps0), (full1, res1, _) = run_ranks(
        2, resume_rank, str(tmp_path), timeout=240)
    assert steps0 == 512
    ck = torch.load(tmp_path / "split" / "mp_resume" / "exp__steps_000000000512.pt",
                    weights_only=True)
    assert len(ck["act"]) == len(ck["generator"]) == 2
    assert ck["act"][0]["h"].shape == (8, 16)  # each rank's 8 of the 16 envs
    # each rank draws its own episodes
    assert not torch.equal(ck["act"][0]["obs"]["visual"], ck["act"][1]["obs"]["visual"])
    for k in full0:
        np.testing.assert_array_equal(full0[k], full1[k])
        np.testing.assert_array_equal(res0[k], full0[k])
        np.testing.assert_array_equal(res1[k], full1[k])
