"""The port's host envs and worker pool (`embodied_clip_tpu_torch/envs/`, `native/`) on
the CPU.

- `HostGridNav`, `THORObjectNavEnv`, `HabitatNavEnv`, `THORRearrangeEnv` and
  `THORTwoPhaseRearrangeEnv` (over the scripted `tests/fake_thor.py` and
  `tests/fake_habitat.py`) against the JAX package's under the same seeds and actions:
  observations, rewards, dones, infos and (rearrangement) experts equal;
- `VectorEnv`: the contracts of `tests/test_host_envs.py:21-262` and
  `tests/test_host_dagger.py:24-60` run on the port's pool (workers from a fork server):
  stepping and batching, the straggler cutoff, worker death and respawn, a drained
  straggler's episode boundary, the ring's writer death, construction failures, reset
  after deaths and stragglers, `expert_actions`.
"""

import functools
import mmap
import os
import struct

import numpy as np
import pytest

from embodied_clip_tpu.envs import habitat as jax_habitat
from embodied_clip_tpu.envs import host_gridworld as jax_hostgrid
from embodied_clip_tpu.envs import thor as jax_thor
from embodied_clip_tpu.envs import thor_rearrange as jax_rearrange

from embodied_clip_tpu_torch.envs import habitat, host_gridworld, thor, thor_rearrange
from embodied_clip_tpu_torch.envs.host_gridworld import HostGridNav
from embodied_clip_tpu_torch.envs.thor_rearrange import REARRANGE_ACTIONS
from embodied_clip_tpu_torch.envs.vector import VectorEnv, stop_fork_server
from embodied_clip_tpu_torch.native.frame_ring import FrameRing, frame_ring_available

import torch_host_cases as H
from fake_habitat import FakeHabitatEnv
from fake_thor import FakeController

_THOR = dict(scenes=["FakeScene_1"], controller_factory=FakeController, width=64,
             height=64)
_REARRANGE = dict(_THOR, num_misplaced=2, num_toggled_open=1, max_steps=30)


def _habitat_factory(path, split=None):
    return FakeHabitatEnv(path)


# (port module, JAX module, class name, kwargs, steps, whether an expert drives half
# the steps)
ENVS = {
    "hostgrid": (host_gridworld, jax_hostgrid, "HostGridNav", dict(size=5, max_steps=12),
                 80, False),
    "thor_objectnav": (thor, jax_thor, "THORObjectNavEnv",
                       dict(_THOR, max_steps=15, shaping=0.1), 60, False),
    "habitat": (habitat, jax_habitat, "HabitatNavEnv",
                dict(config_path="fake.yaml", max_steps=15, env_factory=_habitat_factory),
                60, False),
    "thor_rearrange": (thor_rearrange, jax_rearrange, "THORRearrangeEnv", _REARRANGE, 80,
                       True),
    "thor_two_phase": (thor_rearrange, jax_rearrange, "THORTwoPhaseRearrangeEnv",
                       dict(_REARRANGE, walkthrough_budget=8), 80, True),
}


def _assert_obs_equal(got, want, what):
    assert set(got) == set(want), what
    for k in got:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


@pytest.mark.parametrize("kind", list(ENVS))
def test_host_env_matches_jax(kind):
    mod, jmod, cls, kw, steps, expert = ENVS[kind]
    for seed in (0, 3):
        env, jenv = getattr(mod, cls)(seed=seed, **kw), getattr(jmod, cls)(seed=seed, **kw)
        assert env.num_actions == jenv.num_actions
        _assert_obs_equal(env.reset(), jenv.reset(), f"{kind} reset")
        rng = np.random.RandomState(seed)
        dones = 0
        for t in range(steps):
            if expert:
                a = env.expert_action()
                assert a == jenv.expert_action(), (kind, t)
                if rng.rand() < 0.5:
                    a = rng.randint(env.num_actions)
            else:
                a = rng.randint(env.num_actions)
            obs, r, d, info = env.step(int(a))
            jobs, jr, jd, jinfo = jenv.step(int(a))
            _assert_obs_equal(obs, jobs, f"{kind} step {t}")
            assert (r, d, info) == (jr, jd, jinfo), (kind, t)
            dones += d
        assert dones >= 1, f"{kind}: no episode ended in {steps} steps"
        env.close()
        jenv.close()


def _venv(n=3, **kw):
    return VectorEnv(H.hostgrid_fns(range(n)), frame_shape=H.FRAME, **kw)


def test_vector_env_steps_and_batches():
    assert frame_ring_available()
    venv = _venv(3)
    try:
        assert venv.ring is not None  # frames come through the shared-memory ring
        obs = venv.reset()
        assert obs["visual"].shape == (3, 56, 56, 3)
        want = [HostGridNav(size=5, seed=i) for i in range(3)]
        for w, o in zip(want, obs["visual"]):
            np.testing.assert_array_equal(w.reset()["visual"], o)
        obs, rewards, dones, infos, valid = venv.step(np.array([0, 1, 2]))
        assert obs["visual"].shape == (3, 56, 56, 3)
        assert rewards.shape == (3,) and valid.all()
        for i, (w, a) in enumerate(zip(want, (0, 1, 2))):
            wo, wr, wd, _ = w.step(a)
            np.testing.assert_array_equal(wo["visual"], obs["visual"][i])
            assert (wr, wd) == (rewards[i], dones[i])
        assert not np.array_equal(obs["visual"][0], obs["visual"][1])
    finally:
        venv.close()


def test_vector_env_pipes_frames_without_frame_shape():
    venv = VectorEnv(H.hostgrid_fns(range(2)))
    try:
        assert venv.ring is None
        assert venv.reset()["visual"].shape == (2, 56, 56, 3)
        obs, _, _, _, valid = venv.step(np.array([0, 1]))
        assert obs["visual"].shape == (2, 56, 56, 3) and valid.all()
    finally:
        venv.close()


def test_vector_env_straggler_cutoff_flags():
    venv = _venv(3, cutoff_fraction=0.5, cutoff_timeout_s=5.0)
    try:
        venv.reset()
        _, _, _, _, valid = venv.step(np.array([1, 1, 1]))
        assert valid.sum() >= 2  # the cutoff may return with ceil(0.5·3) = 2 replies
    finally:
        venv.close()


def test_vector_env_worker_death_recovery():
    """A worker killed mid-rollout: the pool does not hang, masks it invalid, respawns
    it (from the fork server), flags the respawned worker's first transition invalid
    and done, and is whole again on the step after."""
    venv = _venv(3, cutoff_timeout_s=3.0)
    try:
        venv.reset()
        venv.step(np.array([0, 0, 0]))
        venv.procs[1].kill()
        venv.procs[1].join(timeout=5)
        obs, _, _, _, valid = venv.step(np.array([1, 1, 1]))
        assert valid[0] and valid[2] and not valid[1]
        assert obs["visual"].shape == (3, 56, 56, 3)  # the stale obs repeated
        _, _, dones, _, valid = venv.step(np.array([2, 2, 2]))
        assert venv.respawn_count == 1 and venv.procs[1].is_alive()
        assert valid[0] and valid[2]
        assert not valid[1] and dones[1]
        _, _, _, _, valid = venv.step(np.array([0, 0, 0]))
        assert valid.all()
    finally:
        venv.close()


def test_drained_straggler_done_masks_next_transition():
    """A straggler whose delayed reply crossed an episode boundary has its next
    transition masked invalid and done."""
    fns = [functools.partial(H.SlowDoneSecondStep, slow=(i == 2), size=5, seed=i)
           for i in range(3)]
    venv = VectorEnv(fns, frame_shape=H.FRAME, cutoff_fraction=0.67, cutoff_timeout_s=0.05)
    try:
        venv.reset()
        _, _, d1, _, v1 = venv.step(np.zeros(3, np.int64))
        assert v1.all() and not d1[2]
        _, _, d2, _, v2 = venv.step(np.zeros(3, np.int64))
        assert not v2[2] and not d2[2]
        _, _, d3, _, v3 = venv.step(np.zeros(3, np.int64))
        assert not v3[2] and d3[2]
        assert v3[0] and v3[1]
        _, _, _, _, v4 = venv.step(np.zeros(3, np.int64))
        assert v4.all()
    finally:
        venv.close()


def test_frame_ring_recovers_from_writer_death_mid_write():
    """A writer killed between the odd and even seq stores leaves the slot's seqlock
    odd; the next writer restores a stable parity."""
    ring = FrameRing.create(2, (4, 4, 3))
    try:
        f0 = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
        ring.write(0, f0)
        np.testing.assert_array_equal(ring.read(0), f0)
        with open("/dev/shm" + ring.name, "r+b") as f:
            m = mmap.mmap(f.fileno(), 0)
            seq = struct.unpack_from("<Q", m, 0)[0]
            struct.pack_into("<Q", m, 0, seq | 1)
            m.flush()
            m.close()
        f1 = f0 + 1
        ring.write(0, f1)
        np.testing.assert_array_equal(ring.read(0), f1)
        np.testing.assert_array_equal(ring.read_batch()[0], f1)
    finally:
        ring.close()


def test_vector_env_reports_env_construction_failure():
    venv = VectorEnv([H.bad_env, functools.partial(HostGridNav, size=5, seed=0)],
                     frame_shape=H.FRAME)
    try:
        with pytest.raises(RuntimeError, match="ai2thor is required"):
            venv.reset()
    finally:
        venv.close()


def test_vector_env_reset_survives_death_inside_reset(tmp_path):
    flag = tmp_path / "die_once"
    flag.write_text("1")
    fns = [functools.partial(H.DiesOnFirstReset, str(flag), size=5, seed=i) if i == 1
           else functools.partial(HostGridNav, size=5, seed=i) for i in range(3)]
    venv = VectorEnv(fns, frame_shape=H.FRAME)
    try:
        obs = venv.reset()
        assert obs["visual"].shape == (3, 56, 56, 3)
        assert venv.respawn_count == 1 and venv.procs[1].is_alive()
        _, _, _, _, valid = venv.step(np.zeros(3, np.int64))
        assert valid.all()
    finally:
        venv.close()


def test_vector_env_reset_respawns_idle_dead_worker():
    venv = _venv(3, cutoff_timeout_s=3.0)
    try:
        venv.reset()
        venv.step(np.zeros(3, np.int64))
        venv.procs[2].kill()
        venv.procs[2].join(timeout=5)
        obs = venv.reset()
        assert obs["visual"].shape == (3, 56, 56, 3)
        assert venv.respawn_count == 1 and venv.procs[2].is_alive()
        _, _, _, _, valid = venv.step(np.zeros(3, np.int64))
        assert valid.all()
    finally:
        venv.close()


def test_vector_env_reset_drains_pending_stragglers():
    fns = [functools.partial(H.SlowThirdEnv if i == 2 else HostGridNav, size=5, seed=i)
           for i in range(3)]
    venv = VectorEnv(fns, frame_shape=H.FRAME, cutoff_fraction=0.6, cutoff_timeout_s=0.05)
    try:
        venv.reset()
        for _ in range(6):
            venv.step(np.zeros(3, np.int64))
        obs = venv.reset()
        assert obs["visual"].shape == (3, 56, 56, 3)
        venv.cutoff_timeout_s = 5.0
        venv.cutoff_fraction = 1.0
        _, _, _, _, valid = venv.step(np.zeros(3, np.int64))
        assert valid.all()
    finally:
        venv.close()


def test_straggler_cutoff_no_desync():
    """With a slow worker and cutoff_fraction < 1, valid replies stay in lockstep with
    the commands issued."""
    fns = [functools.partial(H.SlowCounterEnv, slow=True)] + [H.SlowCounterEnv] * 2
    venv = VectorEnv(fns, frame_shape=(4, 4, 3), cutoff_fraction=0.6, cutoff_timeout_s=0.05)
    try:
        venv.reset()
        seen = []
        for s in range(6):
            venv.step_async(np.zeros(venv.n, np.int64))
            obs, _, _, _, valid = venv.step_wait()
            for w in (1, 2):
                assert valid[w] and int(obs["count"][w]) == s + 1
            if valid[0]:
                seen.append(int(obs["count"][0]))
        assert seen == sorted(set(seen)), seen
        venv.step(np.zeros(venv.n, np.int64))
    finally:
        venv.close()


def test_vector_env_expert_actions():
    venv = VectorEnv(H.rearrange_fns(range(3)), frame_shape=(H.THOR_PX, H.THOR_PX, 3))
    try:
        venv.reset()
        experts = venv.expert_actions()
        assert experts.shape == (3,) and experts.dtype == np.int32
        assert all(0 <= a < len(REARRANGE_ACTIONS) for a in experts)
        obs, _, _, _, valid = venv.step(experts)
        assert obs["visual"].shape == (3, 64, 64, 3)
        assert obs["goal_visual"].shape == (3, 64, 64, 3)
        assert valid.all()
    finally:
        venv.close()


def test_expert_actions_survive_worker_death():
    venv = VectorEnv(H.rearrange_fns(range(20, 23)), frame_shape=(H.THOR_PX, H.THOR_PX, 3))
    try:
        venv.reset()
        venv.step(venv.expert_actions())
        venv.procs[1].kill()
        venv.procs[1].join(timeout=5)
        experts = venv.expert_actions()
        assert venv.respawn_count == 1 and venv.procs[1].is_alive()
        assert all(0 <= a < len(REARRANGE_ACTIONS) for a in experts)
        obs, _, _, _, _ = venv.step(experts)
        assert obs["visual"].shape == (3, 64, 64, 3)
        assert venv.expert_actions().shape == (3,)
    finally:
        venv.close()


def _running(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            stat = f.read()
    except FileNotFoundError:
        return False
    return stat[stat.rindex(")") + 2] != "Z"


def test_stop_fork_server_leaves_no_process():
    from multiprocessing import forkserver, resource_tracker

    for _ in range(2):  # a pool after the stop starts a new server
        venv = _venv(n=2)
        try:
            venv.reset()
            _, _, _, _, valid = venv.step(np.zeros(2, np.int64))
            assert valid.all()
            pids = [p.pid for p in venv.procs]
        finally:
            venv.close()
        helpers = [forkserver._forkserver._forkserver_pid, resource_tracker._resource_tracker._pid]
        assert all(pid is not None and _running(pid) for pid in helpers)
        stop_fork_server()
        assert not any(_running(pid) for pid in pids + helpers)
