"""DAgger imitation learning (port of `embodied_clip_tpu/training/dagger.py`).

The reference's iTHOR Rearrangement suite trains 1-phase agents with DAgger
(baselines_ithor_rearrangement.md:7-12: OnePhase*Dagger configs, 40 env processes).
Recipe: roll out a β-mixture of expert and learner actions, label every visited state
with the expert's action, minimise cross-entropy; β anneals from 1 to 0, so the state
distribution moves from the expert's to the learner's.

`DAggerLearner` runs a batched on-device env (the expert computed from the env state);
`HostDAggerLearner` a `VectorEnv` pool, the expert queried from each worker. With
`aggregate_size` > 0 both keep up to that many past expert-labelled rollouts in host
memory (the aggregate, the "D" of DAgger) and train each epoch on one drawn uniformly
from it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from embodied_clip_tpu_torch.models.encoders import _device
from embodied_clip_tpu_torch.models.policy import unroll_policy
from embodied_clip_tpu_torch.training.host_rollout import HostRolloutCollector, keyed_sample
from embodied_clip_tpu_torch.training.optim import ClippedAdam
from embodied_clip_tpu_torch.training.rollout import (
    ActState,
    init_act_state,
    policy_obs,
    sample_actions,
)

__all__ = ["DAggerConfig", "DAggerLearner", "HostDAggerLearner", "supervised_step"]


@dataclasses.dataclass(frozen=True)
class DAggerConfig:
    rollout_len: int = 64
    env_batch: int = 32
    epochs: int = 1
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    beta_decay_iters: int = 100   # β: 1 → 0 linearly over this many iterations
    # Keep up to this many past expert-labelled rollouts (host memory) and take each
    # epoch's step on one drawn uniformly from them. 0 = off (on-policy distillation).
    aggregate_size: int = 0


def _beta(cfg: DAggerConfig, iteration: int) -> float:
    return float(np.clip(1.0 - iteration / cfg.beta_decay_iters, 0.0, 1.0))


def supervised_step(policy, tx: ClippedAdam, obs_seq: Dict[str, torch.Tensor],
                    h0: torch.Tensor, starts: torch.Tensor, expert_seq: torch.Tensor,
                    weights: Optional[torch.Tensor] = None) -> Tuple[float, float]:
    """One cross-entropy update toward the expert's actions over a stored (T, B)
    rollout (the GRU unrolled from h0). `weights` (T, B) masks tainted pairs out of
    the loss and the accuracy. Returns (loss, expert_match) before the step."""
    logits, _, _ = unroll_policy(policy, obs_seq, h0, starts)
    logp = F.log_softmax(logits, -1)
    ce = -logp.gather(-1, expert_seq.long()[..., None])[..., 0]
    acc = (logits.argmax(-1) == expert_seq).float()
    if weights is None:
        loss, match = ce.mean(), acc.mean()
    else:
        w = weights.float()
        denom = w.sum().clamp_min(1.0)
        loss, match = (ce * w).sum() / denom, (acc * w).sum() / denom
    params = list(policy.parameters())
    for p in params:
        p.grad = None
    loss.backward()
    tx.step([p.grad if p.grad is not None else torch.zeros_like(p) for p in params])
    return float(loss.detach()), float(match)


class _Aggregate:
    """Up to `size` past rollouts in host memory; `draw` returns one on `device`."""

    def __init__(self, size: int, rng: np.random.RandomState):
        self.size, self.rng, self.items = size, rng, []

    def add(self, sample) -> None:
        self.items.append(_to(sample, "cpu"))
        if len(self.items) > self.size:
            self.items.pop(0)

    def draw(self, device):
        return _to(self.items[self.rng.randint(len(self.items))], device)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class DAggerLearner:
    """DAgger over a batched on-device env (`envs/rearrange.py`, `envs/gridworld.py`)
    with an `expert_action(state)`. `init` → `train_iteration` …"""

    def __init__(self, env, policy, cfg: DAggerConfig, encode_fn: Optional[Callable] = None,
                 device="cuda"):
        self.env, self.cfg, self.encode_fn = env, cfg, encode_fn
        self.device = _device(device)
        self.policy = policy.to(self.device)
        self.tx = ClippedAdam(self.policy.parameters(), cfg.lr, cfg.max_grad_norm)
        self.aggregate = _Aggregate(cfg.aggregate_size, np.random.RandomState(0))

    def init(self, generator: torch.Generator) -> ActState:
        return init_act_state(self.env, generator, self.cfg.env_batch, self.policy.hidden)

    @torch.no_grad()
    def collect(self, act: ActState, beta: float, generator: torch.Generator):
        """T steps of the β-mixture: (act after, obs_seq, starts, expert_seq, infos)."""
        T, env = self.cfg.rollout_len, self.env
        buf: Dict[str, torch.Tensor] = {}
        starts, experts, infos = [], [], {k: [] for k in ("done", "success", "spl")}
        for t in range(T):
            obs_in = policy_obs(act.obs, act.prev_action, self.encode_fn)
            for k, v in obs_in.items():
                if k not in buf:
                    buf[k] = torch.empty((T,) + tuple(v.shape), dtype=v.dtype,
                                         device=v.device)
                buf[k][t].copy_(v)
            logits, _, h = self.policy({k: v[t] for k, v in buf.items()}, act.h,
                                       act.is_start)
            expert = env.expert_action(act.env_state).long()
            learner_a = sample_actions(logits, generator)
            take_expert = torch.rand(expert.shape, generator=generator,
                                     device=generator.device) < beta
            action = torch.where(take_expert, expert, learner_a)
            env_state, obs, _, done, info = env.step(act.env_state, action, generator)
            starts.append(act.is_start)
            experts.append(expert)
            for k in infos:
                infos[k].append(info[k])
            act = ActState(env_state, obs, h, torch.where(done, env.num_actions, action),
                           done)
        return (act, buf, torch.stack(starts), torch.stack(experts),
                {k: torch.stack(v) for k, v in infos.items()})

    def train_iteration(self, act: ActState, iteration: int, generator: torch.Generator):
        """One DAgger iteration; β anneals linearly with `iteration`. Returns (act,
        metrics)."""
        beta = _beta(self.cfg, iteration)
        h0 = act.h
        act, obs_seq, starts, expert_seq, infos = self.collect(act, beta, generator)
        fresh = (obs_seq, h0, starts, expert_seq)
        if self.cfg.aggregate_size > 0:
            self.aggregate.add(fresh)
        loss = match = 0.0
        for _ in range(self.cfg.epochs):
            sample = (self.aggregate.draw(self.device) if self.cfg.aggregate_size > 0
                      else fresh)
            loss, match = supervised_step(self.policy, self.tx, *sample)
        n_done = float(infos["done"].sum())
        metrics = {"loss": loss, "expert_match": match, "beta": beta, "episodes": n_done,
                   "success": float((infos["success"] * infos["done"]).sum()) / max(n_done, 1),
                   "spl": float((infos["spl"] * infos["done"]).sum()) / max(n_done, 1)}
        if self.cfg.aggregate_size > 0:
            metrics["aggregate_rollouts"] = float(len(self.aggregate.items))
        return act, metrics


class HostDAggerLearner:
    """DAgger over a VectorEnv pool (the reference's deployment for 1-phase
    Rearrangement: 40 simulator processes feeding an accelerator learner,
    baselines_ithor_rearrangement.md:9). Expert labels come from each worker's
    `env.expert_action()`; the supervised update runs on `device`; the aggregate stays
    in host memory. Single process (expert queries do not shard).

    Each update masks tainted (obs, expert) pairs with `collect_dagger`'s weights (the
    JAX package's `train_iteration` drops them and cannot run)."""

    def __init__(self, venv, policy, cfg: DAggerConfig, encode_fn: Optional[Callable] = None,
                 goal_map_fn: Optional[Callable] = None, device="cuda",
                 sample_fn: Callable = keyed_sample):
        self.venv, self.cfg = venv, cfg
        self.device = _device(device)
        self.policy = policy.to(self.device)
        self.collector = HostRolloutCollector(venv, self.policy, encode_fn, goal_map_fn,
                                              device=self.device, sample_fn=sample_fn)
        self.tx = ClippedAdam(self.policy.parameters(), cfg.lr, cfg.max_grad_norm)
        # One generator draws the β-mixture and the aggregate's samples, as in JAX.
        self.rng = np.random.RandomState(0)
        self.aggregate = _Aggregate(cfg.aggregate_size, self.rng)

    def init(self, seed: int = 0) -> None:
        self.collector.reset(seed)

    def train_iteration(self, iteration: int) -> Dict[str, float]:
        """Collect `cfg.rollout_len` steps of the β-mixture, then `cfg.epochs`
        supervised steps (on the fresh rollout, or draws from the aggregate). The
        metrics add the stage split and env_steps_per_s over the wall time."""
        t_start = time.perf_counter()
        beta = _beta(self.cfg, iteration)
        obs_seq, h0, starts, expert_seq, weights, env_metrics = \
            self.collector.collect_dagger(self.cfg.rollout_len, beta, self.rng)
        fresh = (obs_seq, h0, starts, expert_seq, weights)
        if self.cfg.aggregate_size > 0:
            self.aggregate.add(fresh)
        loss = match = 0.0
        with self.collector.timer.stage("update"):
            for _ in range(max(self.cfg.epochs, 1)):
                sample = (self.aggregate.draw(self.device) if self.aggregate.items
                          else fresh)
                loss, match = supervised_step(self.policy, self.tx, *sample)
        metrics = dict(env_metrics)
        metrics.update(loss=loss, expert_match=match, beta=beta,
                       aggregate_rollouts=float(len(self.aggregate.items)))
        steps = float(self.cfg.rollout_len * self.venv.n)
        metrics["env_steps"] = steps
        metrics.update(self.collector.timer.summary())
        metrics["env_steps_per_s"] = steps / max(time.perf_counter() - t_start, 1e-9)
        self.collector.timer.reset()
        return metrics
