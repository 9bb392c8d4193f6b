"""DD-PPO learner for host-env backends, THOR / Habitat / any VectorEnv (port of
`embodied_clip_tpu/training/host_ppo.py`).

`HostRolloutCollector` gathers (T, B) rollouts from the CPU worker pool (the frozen
encoder runs in the act step, on the card), then the update (GAE and K PPO epochs,
`training/ddppo.ppo_update`) runs on the device. This is the reference's deployment
shape: simulators on CPU hosts, the learner on the accelerator.

Multi-process DD-PPO (the reference's N learner processes, baselines_habitat.md:63-69):
each process of a `torch.distributed` group owns a pool and passes its `env_id_offset`
(the first global index of its envs; process p of N equal pools passes p·B_local). The
update then takes each global minibatch's share of this process and sums the gradients
and the batch statistics over processes (`parallel/mesh.py`), as the on-device learner
does, so N processes update as one process with all the envs would.

Straggler tolerance comes from VectorEnv's `cutoff_fraction`.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from embodied_clip_tpu_torch.models.encoders import _device
from embodied_clip_tpu_torch.parallel import mesh
from embodied_clip_tpu_torch.training.ddppo import DDPPOConfig, ppo_update
from embodied_clip_tpu_torch.training.host_rollout import HostRolloutCollector, keyed_sample
from embodied_clip_tpu_torch.training.optim import ClippedAdam
from embodied_clip_tpu_torch.training.ppo import Rollout

__all__ = ["HostPPOLearner"]


class HostPPOLearner:
    """Owns the policy (moved to `device`), its optimizer (`tx`) and the collector over
    this process's pool(s). `init` → `train_iteration` (= `collector.collect` +
    `update`) …  `cfg.env_batch` is not read: the pools decide the batch."""

    def __init__(self, venv, policy, cfg: DDPPOConfig, encode_fn: Optional[Callable] = None,
                 goal_map_fn: Optional[Callable] = None, env_id_offset: int = 0,
                 device="cuda", sample_fn: Callable = keyed_sample):
        """`venv` is one VectorEnv or a list of pools; with several, the collector
        pipelines them (the act step of one group overlaps the others' env steps)."""
        self.cfg = cfg
        self.device = _device(device)
        self.policy = policy.to(self.device)
        self.collector = HostRolloutCollector(venv, self.policy, encode_fn, goal_map_fn,
                                              env_id_offset, self.device, sample_fn)
        self.venv = self.collector.venv
        self.num_envs = self.collector.num_envs
        self.envs = slice(env_id_offset, env_id_offset + self.num_envs)  # global ids
        # On the learner's device: NCCL, the group's backend on the card, reduces no
        # host tensor.
        self.global_envs = int(mesh.all_sum(torch.tensor(self.num_envs, device=self.device)))
        self.tx = ClippedAdam(self.policy.parameters(), cfg.ppo.lr, cfg.ppo.max_grad_norm,
                              cfg.ppo.lr_decay_updates)

    def init(self, seed: int = 0) -> None:
        """Start every process from rank 0's weights and reset the pools; `seed` keys
        the action samples."""
        mesh.replicate(self.policy.parameters())
        self.collector.reset(seed)

    def update(self, rollout: Rollout, last_value: torch.Tensor) -> Dict[str, torch.Tensor]:
        """`ppo_update` of this process's envs. Returns the last minibatch's loss
        metrics (global)."""
        return ppo_update(self.policy, self.tx, self.cfg, rollout, last_value, self.envs,
                          self.global_envs)

    def train_iteration(self) -> Dict[str, float]:
        """One iteration: a rollout of `cfg.rollout_len` steps, then the update. The
        metrics add the stage split (act / env_step / update: seconds, shares, calls) and
        env_steps_per_s over the iteration's wall time (the stages of pipelined groups
        overlap in wall time)."""
        timer = self.collector.timer
        t_start = time.perf_counter()
        rollout, last_value, env_metrics = self.collector.collect(self.cfg.rollout_len)
        with timer.stage("update"):
            loss_metrics = {k: mesh.host_scalar(v)  # waits for the update
                            for k, v in self.update(rollout, last_value).items()}
        metrics = dict(env_metrics)
        metrics.update(loss_metrics)
        steps = float(self.cfg.rollout_len * self.global_envs)  # all processes' envs
        metrics["env_steps"] = steps
        metrics.update(timer.summary())
        metrics["env_steps_per_s"] = steps / max(time.perf_counter() - t_start, 1e-9)
        timer.reset()
        return metrics
