"""Rollout collection on the device (port of `embodied_clip_tpu/training/rollout.py`).

Each of the T steps: encode the observation's frames (`encode_fn`, the frozen encoder,
when the env emits uint8 frames), one policy step, sample actions, step the env (which
replaces finished episodes), and mark `prev_action` "none" where an episode ended. The
(T, B, ...) storage is allocated on the device before the first step and filled in
place. The encoder runs under `torch.inference_mode()`; its features are copied into
that ordinary storage, since an inference tensor cannot be saved for the backward pass
of the PPO update. A rollout is one span, `rollout`, with each step's `rollout.encode`
(the observation's features), `rollout.policy` (forward, sampling, log-probability; and
the bootstrap value), `rollout.env` (`env.step`) and `rollout.store` (the writes into
the storage and the carry) inside (`utils/profiling.py`).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from embodied_clip_tpu_torch.training.ppo import Rollout
from embodied_clip_tpu_torch.utils.profiling import span

__all__ = ["ActState", "init_act_state", "collect_rollout", "policy_obs", "sample_actions"]


class ActState(NamedTuple):
    """Carry between rollouts: env state, last obs, policy hidden, prev action, and
    whether the next step begins an episode."""

    env_state: object
    obs: Dict[str, torch.Tensor]
    h: torch.Tensor
    prev_action: torch.Tensor   # (B,) int64; num_actions = "no previous action"
    is_start: torch.Tensor      # (B,) bool


def init_act_state(env, generator: torch.Generator, batch: int, hidden: int) -> ActState:
    """Reset `batch` envs with `generator` (on its device)."""
    env_state, obs = env.reset(generator, batch)
    dev = generator.device
    return ActState(env_state=env_state, obs=obs,
                    h=torch.zeros(batch, hidden, device=dev),
                    prev_action=torch.full((batch,), env.num_actions, dtype=torch.long,
                                           device=dev),
                    is_start=torch.ones(batch, dtype=torch.bool, device=dev))


def sample_actions(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Categorical samples of (B, A) logits, (B,) int64."""
    return torch.multinomial(logits.softmax(-1), 1, generator=generator)[:, 0]


def policy_obs(obs, prev_action, encode_fn=None, goal_map_fn=None):
    """The policy's inputs: `obs` with its frames encoded (`encode_fn`), its goals mapped
    (`goal_map_fn`) and the previous actions."""
    o = dict(obs)
    if encode_fn is not None:
        o["visual"] = encode_fn(o["visual"])
    if goal_map_fn is not None:
        o["goal"] = goal_map_fn(o["goal"])
    o["prev_action"] = prev_action
    return o


@torch.no_grad()
def collect_rollout(env, policy, act: ActState, num_steps: int, generator: torch.Generator,
                    encode_fn: Optional[Callable] = None,
                    sample_fn: Callable = sample_actions,
                    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """Collect a (T=num_steps, B) rollout with the current policy.

    `encode_fn` maps raw observations to the policy's visual features (the frozen
    encoder when the env emits uint8 frames). `sample_fn(logits, generator)` draws the
    actions. `reduce` sums over the ranks of a data-parallel run, so that the episode
    metrics are the global batch's. Returns (rollout, last_value (B,), new act state,
    episode metrics)."""
    total = reduce if reduce is not None else (lambda x: x)
    with span("rollout"):
        b = act.h.shape[0]
        buf: Dict[str, torch.Tensor] = {}

        def new(dtype, *shape):
            return torch.empty((num_steps, b) + shape, dtype=dtype, device=act.h.device)

        starts, dones = new(torch.bool), new(torch.bool)
        actions = new(torch.long)
        logps, values, rewards = new(torch.float32), new(torch.float32), new(torch.float32)
        infos = {k: new(torch.float32) for k in ("done", "success", "spl", "episode_len")}
        h0 = act.h
        for t in range(num_steps):
            with span("rollout.encode"):
                obs_in = policy_obs(act.obs, act.prev_action, encode_fn)
            with span("rollout.store"):
                for k, v in obs_in.items():
                    if k not in buf:
                        buf[k] = new(v.dtype, *v.shape[1:])
                    buf[k][t].copy_(v)
            with span("rollout.policy"):
                logits, value, h = policy({k: v[t] for k, v in buf.items()}, act.h,
                                          act.is_start)
                action = sample_fn(logits, generator)
                logps[t] = F.log_softmax(logits, -1).gather(1, action[:, None])[:, 0]
            with span("rollout.env"):
                env_state, obs, reward, done, info = env.step(act.env_state, action,
                                                              generator)
            with span("rollout.store"):
                starts[t], actions[t], values[t], rewards[t], dones[t] = (
                    act.is_start, action, value, reward, done)
                for k in infos:
                    infos[k][t] = info[k]
                prev_action = torch.where(done, env.num_actions, action)
                act = ActState(env_state, obs, h, prev_action, done)

        # Bootstrap value for the state after the last step.
        with span("rollout.encode"):
            obs_in = policy_obs(act.obs, act.prev_action, encode_fn)
        with span("rollout.policy"):
            _, last_value, _ = policy(obs_in, act.h, act.is_start)
        rollout = Rollout(obs=buf, is_start=starts, actions=actions, log_probs=logps,
                          values=values, rewards=rewards, dones=dones, h0=h0)
        # Episode metrics over the episodes that finished in this window.
        done_f = infos["done"]
        sums = total(torch.stack([done_f.sum(), (infos["success"] * done_f).sum(),
                                  (infos["spl"] * done_f).sum(),
                                  (infos["episode_len"] * done_f).sum(), rewards.sum(),
                                  torch.full((), float(rewards.numel()),
                                             device=rewards.device)]))
        n_done = sums[0].clamp_min(1.0)
        metrics = {"episodes": sums[0], "success": sums[1] / n_done, "spl": sums[2] / n_done,
                   "episode_len": sums[3] / n_done, "reward_per_step": sums[4] / sums[5]}
    return rollout, last_value, act, metrics
