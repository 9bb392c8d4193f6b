"""The released RoboTHOR ObjectNav actor-critic, allenact v0.5.0's
`ResnetTensorNavActorCritic` (port of `embodied_clip_tpu/models/allenact_policy.py`).

The reference's eval contract is "download the released `.pt`, eval it"
(readme_files/baselines_robothor_objectnav.md:54-68). This module carries allenact's
own parameter names, so a released state_dict loads with `load_state_dict` and needs no
permutation:

  goal_visual_encoder.embed_goal                 goal-class embedding
  goal_visual_encoder.resnet_compressor.{0,2}    1×1 convs over the frozen conv map
  goal_visual_encoder.target_obs_combiner.{0,2}  1×1 convs over [compressed, goal]
  state_encoders.single_belief.rnn               one-layer `nn.GRU`
  actor.linear / critic.fc                       the heads (allenact's LinearActorHead
                                                 registers `linear`, LinearCriticHead `fc`)
  prev_action_embedder.fc                        only in add_prev_actions checkpoints

It takes the port's NHWC `clip_conv`, permutes it to NCHW for the 1×1 convs and
flattens the combiner's output in CHW order, as allenact does. The prev-action
embedding (allenact's FeatureEmbedding) indexes row 0 at episode starts and `action + 1`
otherwise; the port's prev-action "none" is `num_actions`, which maps to row 0.

It exposes the (obs, h, is_start) → (logits, value, h) surface of
`models/policy.ActorCritic` and its unroll blocks (`features`, `gru_step`, `heads`), so
the host learners and `evaluate_policy_host` drive either.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn

__all__ = ["AllenActResnetPolicy", "allenact_config", "load_allenact_checkpoint"]

_PRE = "goal_visual_encoder."


class _GoalVisualEncoder(nn.Module):
    def __init__(self, in_channels: int, num_goal_classes: int, goal_dims: int,
                 compressor_dims: Tuple[int, int], combiner_dims: Tuple[int, int]):
        super().__init__()
        c1, c2 = compressor_dims
        k1, k2 = combiner_dims
        self.embed_goal = nn.Embedding(num_goal_classes, goal_dims)
        self.resnet_compressor = nn.Sequential(
            nn.Conv2d(in_channels, c1, 1), nn.ReLU(), nn.Conv2d(c1, c2, 1), nn.ReLU())
        self.target_obs_combiner = nn.Sequential(
            nn.Conv2d(c2 + goal_dims, k1, 1), nn.ReLU(), nn.Conv2d(k1, k2, 1))

    def forward(self, visual_nhwc: torch.Tensor, goal: torch.Tensor) -> torch.Tensor:
        w = self.resnet_compressor[0].weight
        x = self.resnet_compressor(visual_nhwc.to(w.dtype).permute(0, 3, 1, 2))
        g = self.embed_goal(goal.long())[:, :, None, None].expand(-1, -1, *x.shape[2:])
        x = self.target_obs_combiner(torch.cat([x, g], 1))
        return x.flatten(1)  # CHW order, as allenact flattens


class _BeliefEncoder(nn.Module):
    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.rnn = nn.GRU(input_size, hidden, 1)


class _Head(nn.Module):
    def __init__(self, name: str, hidden: int, out: int):
        super().__init__()
        self.add_module(name, nn.Linear(hidden, out))


class _PrevActionEmbedder(nn.Module):
    def __init__(self, num_actions: int, dims: int):
        super().__init__()
        self.fc = nn.Embedding(num_actions + 1, dims)


class AllenActResnetPolicy(nn.Module):
    """allenact `ResnetTensorNavActorCritic` over a frozen conv map (B, G, G, C) (e.g.
    CLIP RN50's (B, 7, 7, 2048)) and an integer goal class."""

    def __init__(self, in_channels: int = 2048, grid: int = 7, num_actions: int = 6,
                 num_goal_classes: int = 12, goal_dims: int = 32,
                 compressor_dims: Tuple[int, int] = (128, 32),
                 combiner_dims: Tuple[int, int] = (128, 32), hidden: int = 512,
                 prev_action_embed_dims: int = 0, seed: int = 0):
        """Weights are torch's default initialisation from a CPU generator seeded with
        `seed`, so every device gets the same ones."""
        super().__init__()
        self.num_actions, self.hidden, self.grid = num_actions, hidden, grid
        self.prev_action_embed_dims = prev_action_embed_dims
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.goal_visual_encoder = _GoalVisualEncoder(
                in_channels, num_goal_classes, goal_dims, tuple(compressor_dims),
                tuple(combiner_dims))
            self.state_encoders = nn.ModuleDict({"single_belief": _BeliefEncoder(
                combiner_dims[1] * grid * grid + prev_action_embed_dims, hidden)})
            if prev_action_embed_dims:
                self.prev_action_embedder = _PrevActionEmbedder(num_actions,
                                                                prev_action_embed_dims)
            self.actor = _Head("linear", hidden, num_actions)
            self.critic = _Head("fc", hidden, 1)

    @property
    def rnn(self) -> nn.GRU:
        return self.state_encoders["single_belief"].rnn

    def initial_state(self, batch: int, device=None) -> torch.Tensor:
        return torch.zeros(batch, self.hidden, device=device)

    # -- unroll building blocks (models/policy.unroll_policy's protocol)

    def features(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        x = self.goal_visual_encoder(obs["visual"], obs["goal"])
        if self.prev_action_embed_dims:
            pa = obs["prev_action"].long()
            idx = torch.where(pa >= self.num_actions, 0, pa + 1)
            x = torch.cat([x, self.prev_action_embedder.fc(idx)], -1)
        return x

    def gru_step(self, x: torch.Tensor, h: torch.Tensor, done: torch.Tensor):
        """Hidden state zeroed where `done` (an episode starts), then one GRU step;
        returns (new hidden, output), which are the same tensor. The step is the GRU
        cell over `rnn`'s weights: one layer, one step of `nn.GRU` computes the same
        function, and the cell skips cuDNN's per-call RNN set-up, which dominates the
        host's time in an unrolled backward pass."""
        rnn = self.rnn
        h = torch.gru_cell(x, torch.where(done[:, None], 0.0, h), rnn.weight_ih_l0,
                           rnn.weight_hh_l0, rnn.bias_ih_l0, rnn.bias_hh_l0)
        return h, h

    def heads(self, out: torch.Tensor):
        return self.actor.linear(out), self.critic.fc(out)[..., 0]

    def forward(self, obs: Dict[str, torch.Tensor], h: torch.Tensor,
                done: Optional[torch.Tensor] = None):
        if done is None:
            done = torch.zeros(h.shape[0], dtype=torch.bool, device=h.device)
        h, out = self.gru_step(self.features(obs), h, done)
        logits, value = self.heads(out)
        return logits, value, h


def _state_dict(raw: Mapping) -> Dict[str, torch.Tensor]:
    """The model state_dict of a raw one or of allenact's checkpoint dict, with a
    re-exported checkpoint's `critic.linear.*` renamed to the released `critic.fc.*`."""
    if "model_state_dict" in raw:
        raw = raw["model_state_dict"]
    sd = {k: torch.as_tensor(v) for k, v in raw.items()}
    for p in ("weight", "bias"):
        if f"critic.linear.{p}" in sd and f"critic.fc.{p}" not in sd:
            sd[f"critic.fc.{p}"] = sd.pop(f"critic.linear.{p}")
    return sd


def allenact_config(state_dict: Mapping, grid: int = 7) -> Dict:
    """`AllenActResnetPolicy`'s constructor arguments for a ResnetTensorNavActorCritic
    state_dict (`grid` is the conv map's side, 7 for RN50 at 224)."""
    sd = _state_dict(state_dict)
    required = [f"{_PRE}embed_goal.weight", f"{_PRE}resnet_compressor.0.weight",
                f"{_PRE}resnet_compressor.2.weight", f"{_PRE}target_obs_combiner.0.weight",
                f"{_PRE}target_obs_combiner.2.weight",
                "state_encoders.single_belief.rnn.weight_hh_l0",
                "state_encoders.single_belief.rnn.weight_ih_l0",
                "actor.linear.weight", "critic.fc.weight"]
    missing = [k for k in required if k not in sd]
    if missing:
        raise ValueError(f"state_dict is not a ResnetTensorNavActorCritic checkpoint — "
                         f"missing keys {missing[:4]}{'…' if len(missing) > 4 else ''}")
    pa = sd.get("prev_action_embedder.fc.weight")
    cfg = dict(
        in_channels=int(sd[f"{_PRE}resnet_compressor.0.weight"].shape[1]), grid=grid,
        num_actions=int(sd["actor.linear.weight"].shape[0]),
        num_goal_classes=int(sd[f"{_PRE}embed_goal.weight"].shape[0]),
        goal_dims=int(sd[f"{_PRE}embed_goal.weight"].shape[1]),
        compressor_dims=(int(sd[f"{_PRE}resnet_compressor.0.weight"].shape[0]),
                         int(sd[f"{_PRE}resnet_compressor.2.weight"].shape[0])),
        combiner_dims=(int(sd[f"{_PRE}target_obs_combiner.0.weight"].shape[0]),
                       int(sd[f"{_PRE}target_obs_combiner.2.weight"].shape[0])),
        hidden=int(sd["state_encoders.single_belief.rnn.weight_hh_l0"].shape[1]),
        prev_action_embed_dims=int(pa.shape[1]) if pa is not None else 0)
    feat = int(sd["state_encoders.single_belief.rnn.weight_ih_l0"].shape[1])
    if feat != cfg["combiner_dims"][1] * grid * grid + cfg["prev_action_embed_dims"]:
        raise ValueError(f"GRU input width {feat} != combiner_out·grid² + prev_action_dims "
                         f"({cfg['combiner_dims'][1]}·{grid}² + "
                         f"{cfg['prev_action_embed_dims']}): wrong grid for this checkpoint")
    return cfg


def load_allenact_checkpoint(path: str, grid: int = 7, device="cpu") -> AllenActResnetPolicy:
    """A released allenact `.pt` (`{"model_state_dict": ..., ...}` or a bare state_dict)
    as an `AllenActResnetPolicy` on `device`."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = _state_dict(raw)
    policy = AllenActResnetPolicy(**allenact_config(sd, grid))
    policy.load_state_dict(sd)
    return policy.to(device)
