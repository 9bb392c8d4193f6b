"""PPO: generalized advantage estimation + clipped surrogate/value losses (port of
`embodied_clip_tpu/training/ppo.py`).

Conventions, as in the JAX package:
  done[t]      episode ended after step t (stops the GAE bootstrap across the boundary)
  is_start[t]  episode begins at step t (hidden state reset in the unroll)
The loss recomputes logits and values by unrolling the GRU over the stored sequence with
the current weights (`models/policy.unroll_policy`, shared with the rollout).

In a data-parallel run `ppo_loss` is given `reduce`, a sum over ranks: the advantage
statistics and the mean denominators are then the global batch's, as in the JAX SPMD
step, and each rank's loss is its share of the global loss.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from embodied_clip_tpu_torch.models.policy import unroll_policy

__all__ = ["PPOConfig", "Rollout", "compute_gae", "ppo_loss"]


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    value_clip: float = 0.2          # clipped value loss (habitat-style); <=0 disables
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    epochs: int = 4                   # PPO update repeats per rollout
    normalize_advantages: bool = True
    max_grad_norm: float = 0.5
    lr: float = 3e-4
    # Linear LR decay to 0 over this many optimizer updates (0 = constant LR).
    lr_decay_updates: int = 0


class Rollout(NamedTuple):
    """Time-major rollout storage: tensors shaped (T, B, ...)."""

    obs: Dict[str, torch.Tensor]
    is_start: torch.Tensor    # (T, B) bool
    actions: torch.Tensor     # (T, B) int64
    log_probs: torch.Tensor   # (T, B) behaviour log-probs
    values: torch.Tensor      # (T, B) behaviour values
    rewards: torch.Tensor     # (T, B)
    dones: torch.Tensor       # (T, B) bool
    h0: torch.Tensor          # (B, H) hidden state entering step 0
    # (T, B) bool, or None. False marks straggler-cutoff steps (a fabricated
    # transition), excluded from GAE and the loss.
    valid: Optional[torch.Tensor] = None

    def envs(self, idx) -> "Rollout":
        """The envs `idx` (a slice over B) of every tensor."""
        return Rollout(obs={k: v[:, idx] for k, v in self.obs.items()},
                       is_start=self.is_start[:, idx], actions=self.actions[:, idx],
                       log_probs=self.log_probs[:, idx], values=self.values[:, idx],
                       rewards=self.rewards[:, idx], dones=self.dones[:, idx],
                       h0=self.h0[idx],
                       valid=None if self.valid is None else self.valid[:, idx])


@torch.no_grad()
def compute_gae(rewards, values, dones, last_value, gamma: float, lam: float, valid=None):
    """GAE(γ,λ) over time-major (T, B) tensors; returns (advantages, returns).

    valid (T, B) bool or None: a step with valid False contributes no delta, and the
    accumulated advantage passes through it unchanged, unless it also marks an episode
    boundary (done), which the carry never crosses."""
    not_done = 1.0 - dones.float()
    next_values = torch.cat([values[1:], last_value[None]], 0)
    w = torch.ones_like(rewards) if valid is None else valid.float()
    advs = torch.empty_like(rewards)
    carry = torch.zeros_like(last_value)
    for t in range(rewards.shape[0] - 1, -1, -1):
        nd, wt = not_done[t], w[t]
        delta = rewards[t] + gamma * next_values[t] * nd - values[t]
        carry = wt * (delta + gamma * lam * nd * carry) + (1.0 - wt) * nd * carry
        advs[t] = carry
    return advs, advs + values


def ppo_loss(policy, rollout: Rollout, advantages, returns, cfg: PPOConfig,
             reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """Clipped-surrogate PPO loss over a (T, B) rollout, possibly a slice of envs.
    Returns (loss, metrics dict of detached scalars).

    `reduce` sums a tensor over the ranks of a data-parallel run (identity if None).
    It is applied to the data-only statistics: the advantage mean and variance and the
    means' denominator. The loss and the metrics are then this rank's share of the
    global ones: their sum over ranks is the global value."""
    total = reduce if reduce is not None else (lambda x: x)
    logits, values, _ = unroll_policy(policy, rollout.obs, rollout.h0, rollout.is_start)
    logp_all = F.log_softmax(logits, -1)
    logp = logp_all.gather(-1, rollout.actions[..., None])[..., 0]
    entropy = -(logp_all.exp() * logp_all).sum(-1)

    # Straggler-cutoff mask: fabricated steps contribute zero loss (and zero grad).
    if rollout.valid is not None:
        w = rollout.valid.float()
        denom = total(w.sum()).clamp_min(1.0)
    else:
        w = torch.ones_like(logp)
        denom = total(torch.full((), float(logp.numel()), device=logp.device))

    def wmean(x):
        return (x * w).sum() / denom

    if cfg.normalize_advantages:
        with torch.no_grad():
            mean = total((advantages * w).sum()) / denom
            var = total((((advantages - mean) ** 2) * w).sum()) / denom
        advantages = (advantages - mean) / (var.sqrt() + 1e-5)

    ratio = (logp - rollout.log_probs).exp()
    surr1 = ratio * advantages
    surr2 = ratio.clamp(1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * advantages
    policy_loss = -wmean(torch.minimum(surr1, surr2))

    if cfg.value_clip > 0:
        v_clipped = rollout.values + (values - rollout.values).clamp(-cfg.value_clip,
                                                                      cfg.value_clip)
        v_loss = torch.maximum((values - returns) ** 2, (v_clipped - returns) ** 2)
    else:
        v_loss = (values - returns) ** 2
    value_loss = 0.5 * wmean(v_loss)

    entropy_bonus = wmean(entropy)
    loss = policy_loss + cfg.value_coef * value_loss - cfg.entropy_coef * entropy_bonus
    with torch.no_grad():
        metrics = {
            "loss": loss.detach(),
            "policy_loss": policy_loss.detach(),
            "value_loss": value_loss.detach(),
            "entropy": entropy_bonus.detach(),
            "approx_kl": wmean(rollout.log_probs - logp),
            "clip_frac": wmean(((ratio - 1.0).abs() > cfg.clip_eps).float()),
        }
    return loss, metrics
