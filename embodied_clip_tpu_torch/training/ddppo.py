"""DD-PPO learner: rollout + GAE + PPO epochs (port of
`embodied_clip_tpu/training/ddppo.py`).

The JAX package runs one jitted SPMD step: the env batch is sharded over the mesh's
`dp` axis, params and optimizer state are replicated, and XLA inserts the gradient
all-reduce. Here each process of a `torch.distributed` group (or the only process) owns a
contiguous slice of the env batch (`parallel/mesh.shard_batch`) and collects its
rollout. The update takes the same K epochs × m minibatches as JAX: minibatch i is the
same GLOBAL env slice JAX takes, and each process computes the loss over its share of
that slice, a sum over its elements divided by the global denominators (summed over
processes, with the advantage statistics). The gradients are summed over processes, then
clipped by their global norm and applied: the JAX update for any process count, any m
and any B, uneven ones included.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from embodied_clip_tpu_torch.models.encoders import _device
from embodied_clip_tpu_torch.parallel import mesh
from embodied_clip_tpu_torch.training.optim import ClippedAdam
from embodied_clip_tpu_torch.training.ppo import PPOConfig, Rollout, compute_gae, ppo_loss
from embodied_clip_tpu_torch.training.rollout import ActState, collect_rollout, init_act_state

__all__ = ["DDPPOConfig", "DDPPOLearner", "iter_minibatches", "ppo_update"]


@dataclasses.dataclass(frozen=True)
class DDPPOConfig:
    rollout_len: int = 64
    env_batch: int = 32              # global env count (split over processes)
    num_minibatches: int = 1         # contiguous env slices; 1 == full batch
    ppo: PPOConfig = dataclasses.field(default_factory=PPOConfig)


def _minibatch_slices(batch: int, m: int):
    """The m contiguous env slices of a batch of `batch` envs (habitat DD-PPO's
    recurrent generator: whole sequences, sliced over envs). The remainder spreads over
    the first slices; empty slices are skipped."""
    start = 0
    for size in mesh.split_sizes(batch, max(m, 1)):
        if size:
            yield slice(start, start + size)
        start += size


def iter_minibatches(m: int, rollout: Rollout, advantages, returns):
    """Split a (T, B) rollout into m contiguous env-slice minibatches, as the JAX
    package does."""
    for sl in _minibatch_slices(rollout.actions.shape[1], m):
        yield rollout.envs(sl), advantages[:, sl], returns[:, sl]


def ppo_update(policy, tx: ClippedAdam, cfg: DDPPOConfig, rollout: Rollout,
               last_value: torch.Tensor, own: slice, global_batch: int
               ) -> Dict[str, torch.Tensor]:
    """GAE, then K epochs × m minibatches of PPO on this process's share of each global
    minibatch; gradients summed over processes before the clipped Adam step. `rollout`
    holds the envs `own` (a slice of the `global_batch` envs of all processes). Returns
    the last minibatch's loss metrics (global)."""
    ppo = cfg.ppo
    advantages, returns = compute_gae(rollout.rewards, rollout.values, rollout.dones,
                                      last_value, ppo.gamma, ppo.gae_lambda,
                                      valid=rollout.valid)
    params = list(policy.parameters())
    metrics = {}
    for _ in range(ppo.epochs):
        for sl in _minibatch_slices(global_batch, cfg.num_minibatches):
            lo = min(max(sl.start, own.start), own.stop) - own.start
            hi = max(min(sl.stop, own.stop), own.start) - own.start
            loss, metrics = ppo_loss(policy, rollout.envs(slice(lo, hi)),
                                     advantages[:, lo:hi], returns[:, lo:hi], ppo,
                                     reduce=mesh.all_sum)
            for p in params:
                p.grad = None
            loss.backward()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            mesh.all_sum_(grads)
            tx.step(grads)
    names = list(metrics)
    summed = mesh.all_sum(torch.stack([metrics[k] for k in names]))
    return dict(zip(names, summed))


class DDPPOLearner:
    """Owns the policy (moved to `device`), its optimizer (`tx`) and this process's env
    slice. `init` → `train_iteration` (= `collect` + `update`) …"""

    def __init__(self, env, policy, cfg: DDPPOConfig, encode_fn: Optional[Callable] = None,
                 device="cuda"):
        self.env, self.cfg, self.encode_fn = env, cfg, encode_fn
        self.device = _device(device)
        self.policy = policy.to(self.device)
        self.tx = ClippedAdam(self.policy.parameters(), cfg.ppo.lr, cfg.ppo.max_grad_norm,
                              cfg.ppo.lr_decay_updates)
        self.envs = mesh.shard_batch(cfg.env_batch)  # this process's env slice

    def init(self, generator: torch.Generator) -> ActState:
        """Start every process from rank 0's weights and reset this process's envs with
        `generator` (on the learner's device)."""
        mesh.replicate(self.policy.parameters())
        return init_act_state(self.env, generator, self.envs.stop - self.envs.start,
                              self.policy.hidden)

    def collect(self, act: ActState, generator: torch.Generator):
        """(rollout, last_value, act, env metrics) of this process's envs."""
        return collect_rollout(self.env, self.policy, act, self.cfg.rollout_len, generator,
                               self.encode_fn, reduce=mesh.all_sum)

    def update(self, rollout: Rollout, last_value: torch.Tensor) -> Dict[str, torch.Tensor]:
        """`ppo_update` of this process's env slice. Returns the last minibatch's loss
        metrics (global)."""
        return ppo_update(self.policy, self.tx, self.cfg, rollout, last_value, self.envs,
                          self.cfg.env_batch)

    def train_iteration(self, act: ActState, generator: torch.Generator
                        ) -> Tuple[ActState, Dict[str, torch.Tensor]]:
        """One DD-PPO iteration: T steps of this process's envs, then the update."""
        rollout, last_value, act, env_metrics = self.collect(act, generator)
        metrics = {**env_metrics, **self.update(rollout, last_value)}
        metrics["env_steps"] = torch.tensor(float(self.cfg.rollout_len * self.cfg.env_batch))
        return act, metrics
