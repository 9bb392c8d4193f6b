"""Shared cases for the host-simulator parity tests (`test_torch_host_envs.py`,
`test_torch_host_rollout.py`, `test_torch_rearrange_dagger.py`): env factories and
scripted envs that the port's `VectorEnv` workers unpickle. The workers start from a
fork server and import this module by name, so it imports no JAX and defines every
class at module level.
"""

from __future__ import annotations

import functools
import os
import time

import numpy as np
import torch

from embodied_clip_tpu_torch.envs.host_gridworld import HostGridNav
from embodied_clip_tpu_torch.envs.thor_rearrange import THORRearrangeEnv
from fake_thor import FakeController

FRAME = (56, 56, 3)     # HostGridNav frames
THOR_PX = 64            # the fake THOR controller's frames in the tests


def hostgrid_fns(seeds, **kw):
    return [functools.partial(HostGridNav, size=5, seed=s, **kw) for s in seeds]


def rearrange_fns(seeds, **kw):
    """The port's 1-phase THOR rearrangement over the scripted controller."""
    return [functools.partial(
        THORRearrangeEnv, scenes=["FakeScene_1"], controller_factory=FakeController,
        width=THOR_PX, height=THOR_PX, num_misplaced=1, num_toggled_open=0,
        max_steps=40, visibility_distance=1.5, seed=s, **kw) for s in seeds]


class SlowDoneSecondStep(HostGridNav):
    """Its second step sleeps past the cutoff and ends the episode (when `slow`)."""

    calls = 0

    def __init__(self, slow, **kw):
        super().__init__(**kw)
        self._slow = slow

    def step(self, a):
        type(self).calls += 1
        obs, r, d, info = super().step(a)
        if self._slow and type(self).calls == 2:
            time.sleep(0.6)
            d = True  # the delayed reply ends the episode
            obs = self.reset()
        return obs, r, d, info


class SlowThirdEnv(HostGridNav):
    """Every third step sleeps 0.4 s."""

    calls = 0

    def step(self, a):
        type(self).calls += 1
        if type(self).calls % 3 == 0:
            time.sleep(0.4)
        return super().step(a)


class DiesOnFirstReset(HostGridNav):
    """Exits inside its first `reset` while `flag` exists (a simulator crash)."""

    def __init__(self, flag, **kw):
        self._flag = flag
        super().__init__(**kw)

    def reset(self):
        if os.path.exists(self._flag):
            os.unlink(self._flag)
            os._exit(1)
        return super().reset()


def bad_env():
    raise ImportError("ai2thor is required for THORRearrangeEnv")


class SlowCounterEnv:
    """HostEnv stub: a per-worker step counter in its frames and obs; optionally slow."""

    num_actions = 2

    def __init__(self, slow=False):
        self.slow = slow
        self.count = 0

    def _obs(self):
        return {"visual": np.full((4, 4, 3), self.count % 256, np.uint8),
                "count": np.int64(self.count)}

    def reset(self):
        return self._obs()

    def step(self, action):
        if self.slow:
            time.sleep(0.25)
        self.count += 1
        return self._obs(), 0.0, False, {"count": self.count}

    def close(self):
        pass


class ScriptedVenv:
    """An in-process stand-in for a `VectorEnv` of HostGridNav envs whose `step_wait`
    flags env `bad` invalid at the global steps in `invalid_at` (a fabricated
    transition), for the DAgger taint mask."""

    cutoff_fraction = 1.0
    num_actions = 6

    def __init__(self, n, bad, invalid_at):
        self.n, self.bad, self.invalid_at = n, bad, set(invalid_at)
        self.envs = [HostGridNav(size=5, seed=i) for i in range(n)]
        self.t = 0
        self._respawned_pending = set()

    def reset(self):
        return _stack([e.reset() for e in self.envs])

    def expert_actions(self):
        return np.zeros(self.n, np.int32)

    def step_async(self, actions):
        self._actions = actions

    def step_wait(self):
        outs = [e.step(int(a)) for e, a in zip(self.envs, self._actions)]
        valid = np.ones(self.n, bool)
        if self.t in self.invalid_at:
            valid[self.bad] = False
        self.t += 1
        return (_stack([o[0] for o in outs]), np.array([o[1] for o in outs], np.float32),
                np.array([o[2] for o in outs]), [o[3] for o in outs], valid)


def _stack(obs_list):
    return {k: np.stack([o[k] for o in obs_list]) for k in obs_list[0]}


class StubPool:
    """A pool's size and action count, for learners whose update alone is exercised."""

    num_actions = 6

    def __init__(self, n):
        self.n = n


def flat_encode(frames):
    """A cheap stand-in for the frozen encoder: every 8th pixel of the frames, flat."""
    return frames[:, ::8, ::8].float().flatten(1) / 255.0


def host_update_rank(params_sd, rollout, last_value, cfg, sizes, device="cpu"):
    """One process of a multi-process host DD-PPO update: this rank's pool of
    `sizes[rank]` envs at its `env_id_offset`, `HostPPOLearner.update` on its envs of the
    global rollout, on `device` (on the card: TF32 off, cuDNN deterministic). Returns
    (state_dict after, metrics, each parameter's smallest |gradient| over the steps) as
    numpy."""
    from embodied_clip_tpu_torch.parallel import mesh
    from embodied_clip_tpu_torch.training.host_ppo import HostPPOLearner
    from torch_rl_cases import min_abs_grads, port_policy, record_steps

    r = mesh.rank()
    offset = sum(sizes[:r])
    pol = port_policy()
    pol.load_state_dict(params_sd)
    learner = HostPPOLearner(StubPool(sizes[r]), pol, cfg, env_id_offset=offset,
                             device=device)
    assert learner.global_envs == sum(sizes)
    own, dev = slice(offset, offset + sizes[r]), learner.device
    mine = rollout.envs(own)
    mine = mine._replace(**{f: v.to(dev) for f, v in mine._asdict().items()
                            if isinstance(v, torch.Tensor)},
                         obs={k: v.to(dev) for k, v in mine.obs.items()})
    steps = record_steps(learner.tx)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        metrics = learner.update(mine, last_value[own].to(dev))
    return ({k: v.cpu().numpy().copy() for k, v in pol.state_dict().items()},
            {k: float(v) for k, v in metrics.items()},
            {k: v.numpy() for k, v in min_abs_grads(pol, steps).items()})
