"""A goal-conditioned recurrent actor-critic and its PPO update, in plain PyTorch:
the policy of the DD-PPO ObjectNav baselines (habitat-lab's PPO; the reference
repository's `ddppo` configs) and optax's clipped Adam, written from the published
formulas:

  policy   frozen conv map -> 1x1 conv (128) -> ReLU -> 3x3 conv (32) -> ReLU ->
           flatten NHWC; + goal embedding (32) + previous-action embedding (6) ->
           GRU (gates r, z, n; the recurrent r and z products carry no bias) ->
           actor logits, critic value
  GAE      delta_t = r_t + gamma V_{t+1} (1 - done_t) - V_t,
           A_t = delta_t + gamma lambda (1 - done_t) A_{t+1}, returns = A + V
  PPO      advantages normalised (population variance, + 1e-5 on the std);
           clipped surrogate; value loss max((V - R)^2, (V_old + clip(V - V_old) - R)^2) / 2;
           loss = policy + value_coef * value - entropy_coef * entropy
  optimiser  g <- g * max_norm / |g| where |g| >= max_norm (over all leaves);
           Adam (b1 0.9, b2 0.999, eps 1e-8 outside the root, bias-corrected)

`follow` replays the program's rollouts (their stored encoder features, actions,
rewards, behaviour log-probabilities and values, as data) through this policy from
the weights the benchmark made, and returns what the program's training step is held
to. `compute` sets the precision of its products (float32, or bfloat16 for the
control).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Compressor(nn.Module):
    def __init__(self, cin: int, mid: int = 128, out: int = 32):
        super().__init__()
        self.reduce = nn.Conv2d(cin, mid, 1)
        self.mix = nn.Conv2d(mid, out, 3, padding=1)


class ActorCritic(nn.Module):
    """Parameters only; `follow` computes with them. Names are the port's
    `ActorCritic` state-dict keys, so the same tensors load into both."""

    def __init__(self, num_actions: int, visual_shape, num_goal_classes: int,
                 hidden: int = 512, goal_dim: int = 32):
        super().__init__()
        h, w, c = visual_shape
        self.compressor = Compressor(c)
        self.goal_embed = nn.Embedding(num_goal_classes, goal_dim)
        self.prev_action_embed = nn.Embedding(num_actions + 1, 6)
        self.gru = nn.GRUCell(32 * h * w + goal_dim + 6, hidden)
        self.actor = nn.Linear(hidden, num_actions)
        self.critic = nn.Linear(hidden, 1)


def _unroll(p: dict, ro: dict, dt):
    """Logits (T, B, A) and values (T, B) of a rollout under parameters `p`."""
    t, b = ro["is_start"].shape

    def lin(x, w, bias=None):
        return F.linear(x.to(dt), w.to(dt), None if bias is None else bias.to(dt)).float()

    def conv(x, w, bias, pad):
        return F.conv2d(x.to(dt), w.to(dt), bias.to(dt), padding=pad).float()

    v = ro["visual"].flatten(0, 1).float().permute(0, 3, 1, 2)
    v = F.relu(conv(v, p["compressor.reduce.weight"], p["compressor.reduce.bias"], 0))
    v = F.relu(conv(v, p["compressor.mix.weight"], p["compressor.mix.bias"], 1))
    x = torch.cat([v.permute(0, 2, 3, 1).flatten(1),
                   p["goal_embed.weight"][ro["goal"].flatten(0, 1).long()],
                   p["prev_action_embed.weight"][ro["prev_action"].flatten(0, 1).long()]], -1)
    gi = lin(x, p["gru.weight_ih"], p["gru.bias_ih"]).unflatten(0, (t, b))
    hsz = p["gru.weight_hh"].shape[1]
    h, outs = ro["h0"].float(), []
    for i in range(t):
        h = torch.where(ro["is_start"][i][:, None], 0.0, h)
        gh = lin(h, p["gru.weight_hh"], p["gru.bias_hh"])
        r = torch.sigmoid(gi[i, :, :hsz] + gh[:, :hsz])
        z = torch.sigmoid(gi[i, :, hsz:2 * hsz] + gh[:, hsz:2 * hsz])
        n = torch.tanh(gi[i, :, 2 * hsz:] + r * gh[:, 2 * hsz:])
        h = (1 - z) * n + z * h
        outs.append(h)
    out = torch.stack(outs).flatten(0, 1)
    logits = lin(out, p["actor.weight"], p["actor.bias"]).unflatten(0, (t, b))
    values = lin(out, p["critic.weight"], p["critic.bias"])[:, 0].unflatten(0, (t, b))
    return logits, values


def gae(ro: dict, gamma: float, lam: float):
    rewards, values, dones = ro["rewards"].float(), ro["values"].float(), ro["dones"]
    not_done = 1.0 - dones.float()
    next_v = torch.cat([values[1:], ro["last_value"].float()[None]], 0)
    adv = torch.zeros_like(rewards)
    carry = torch.zeros_like(rewards[0])
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_v[t] * not_done[t] - values[t]
        carry = delta + gamma * lam * not_done[t] * carry
        adv[t] = carry
    return adv, adv + values


def ppo_loss(p: dict, ro: dict, adv, ret, cfg: dict, dt):
    logits, values = _unroll(p, ro, dt)
    logp_all = F.log_softmax(logits, -1)
    logp = logp_all.gather(-1, ro["actions"][..., None])[..., 0]
    entropy = -(logp_all.exp() * logp_all).sum(-1).mean()
    if cfg["normalize_advantages"]:
        adv = (adv - adv.mean()) / (((adv - adv.mean()) ** 2).mean().sqrt() + 1e-5)
    ratio = (logp - ro["log_probs"]).exp()
    policy = -torch.minimum(ratio * adv, ratio.clamp(1 - cfg["clip_eps"], 1 + cfg["clip_eps"])
                            * adv).mean()
    old = ro["values"]
    clipped = old + (values - old).clamp(-cfg["value_clip"], cfg["value_clip"])
    value = 0.5 * torch.maximum((values - ret) ** 2, (clipped - ret) ** 2).mean()
    return policy + cfg["value_coef"] * value - cfg["entropy_coef"] * entropy


def follow(params: dict, rollouts, cfg: dict, compute=torch.float32, grad_mask=None):
    """Replay the rollouts' updates from `params` ({name: tensor}). Returns
    {"losses": every PPO step's loss, "first_grad": {name: the first clipped
    gradient}, "params": {name: the parameters after the last rollout}}.
    `grad_mask` ({name: 0/1 tensor}) zeroes gradient entries that are not parameters
    of the published model (the recurrent r and z biases)."""
    p = {k: v.detach().float().clone().requires_grad_(True) for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps, count = 0.9, 0.999, 1e-8, 0
    losses, first = [], None
    for ro in rollouts:
        with torch.no_grad():
            adv, ret = gae(ro, cfg["gamma"], cfg["gae_lambda"])
        for _ in range(cfg["epochs"]):
            loss = ppo_loss(p, ro, adv, ret, cfg, compute)
            losses.append(float(loss.detach()))
            grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
            with torch.no_grad():
                g = {k: torch.zeros_like(v) if gr is None else gr
                     for (k, v), gr in zip(p.items(), grads)}
                for k, m in (grad_mask or {}).items():
                    g[k] = g[k] * m
                norm = torch.sqrt(sum((v.float() ** 2).sum() for v in g.values()))
                if norm >= cfg["max_grad_norm"]:
                    g = {k: v * (cfg["max_grad_norm"] / norm) for k, v in g.items()}
                if first is None:
                    first = {k: v.clone() for k, v in g.items()}
                count += 1
                for k in p:
                    mu[k] = b1 * mu[k] + (1 - b1) * g[k]
                    nu[k] = b2 * nu[k] + (1 - b2) * g[k] ** 2
                    upd = (mu[k] / (1 - b1 ** count)) / ((nu[k] / (1 - b2 ** count)).sqrt() + eps)
                    p[k] -= cfg["lr"] * upd
    return {"losses": losses, "first_grad": first,
            "params": {k: v.detach() for k, v in p.items()}}


def build(visual_shape, num_actions: int, num_goal_classes: int, hidden: int):
    return ActorCritic(num_actions, visual_shape, num_goal_classes, hidden)
