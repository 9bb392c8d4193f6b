"""Goal-conditioned recurrent actor-critic policies (port of
`embodied_clip_tpu/models/policy.py`).

Frozen visual features (the NHWC CLIP conv map) → small trainable compressor CNN →
concat goal embedding (+ previous action) → one GRU cell → categorical actor + scalar
critic. The modules take the JAX package's NHWC visual input and flatten NHWC, so a
flax Dense kernel converts by a transpose (`models/convert.from_flax_policy_params`).

torch modules need their input widths when built, where flax infers them from the
first batch: `ActorCritic` takes `visual_shape`, the per-sample shape of
`obs["visual"]` ((H, W, C) for a map or frames, (D,) for a flat vector), and `depth`,
whether observations carry a one-channel `obs["depth"]`.

Goal conditioning (`goal_kind`):
  object_embed  learned embedding of the target object class (ObjectNav)
  pointgoal     linear embed of polar target coordinates (PointNav)
  text_embed    frozen CLIP text goal embedding → linear adapter (zero-shot ObjectNav)
  none          unconditioned

The GRU is `torch.nn.GRUCell`. Flax's GRUCell has no bias on its recurrent r and z
products; its input biases play both parts. So the r/z rows of `gru.bias_hh` stay
zero: they are zero at init and a gradient hook zeroes their gradient.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["ActorCritic", "GOAL_KINDS", "ScratchCNN", "VisualCompressor", "unroll_policy"]

GOAL_KINDS = ("object_embed", "pointgoal", "text_embed", "none")

# std of a standard normal truncated to ±2, which flax's truncated LeCun init divides by.
_TRUNC_STD = 0.87962566103423978


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """Flax/XLA "SAME" padding of one spatial dim: out = ceil(n/s), the low side gets
    the smaller half of an odd total (torch's `padding=` is symmetric)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    (kh, kw), (sh, sw) = conv.kernel_size, conv.stride
    top, bottom = _same_pad(x.shape[2], kh, sh)
    left, right = _same_pad(x.shape[3], kw, sw)
    return conv(F.pad(x, (left, right, top, bottom)))


class VisualCompressor(nn.Module):
    """Trainable CNN over the frozen conv map (the allenact-style compressor):
    1×1 → ReLU → 3×3 SAME → ReLU, flattened NHWC."""

    def __init__(self, in_channels: int, mid: int = 128, out: int = 32):
        super().__init__()
        self.reduce = nn.Conv2d(in_channels, mid, 1)
        self.mix = nn.Conv2d(mid, out, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().permute(0, 3, 1, 2)
        x = F.relu(self.mix(F.relu(self.reduce(x))))
        return x.permute(0, 2, 3, 1).flatten(1)


class ScratchCNN(nn.Module):
    """Small visual encoder trained end to end on raw frames (the habitat "scratch"
    baselines): 3 strided SAME convs → flatten NHWC → Dense → ReLU."""

    def __init__(self, in_channels: int, in_hw: Sequence[int], out: int = 512):
        super().__init__()
        self.c1 = nn.Conv2d(in_channels, 32, 8, stride=4)
        self.c2 = nn.Conv2d(32, 64, 4, stride=2)
        self.c3 = nn.Conv2d(64, 64, 3, stride=2)
        h, w = in_hw
        for s in (4, 2, 2):
            h, w = -(-h // s), -(-w // s)
        self.fc = nn.Linear(h * w * 64, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.uint8:
            x = x.float() / 255.0
        x = x.float().permute(0, 3, 1, 2)
        for conv in (self.c1, self.c2, self.c3):
            x = F.relu(_conv_same(conv, x))
        return F.relu(self.fc(x.permute(0, 2, 3, 1).flatten(1)))


class ActorCritic(nn.Module):
    def __init__(self, num_actions: int, visual_shape: Sequence[int],
                 goal_kind: str = "object_embed", num_goal_classes: int = 12,
                 goal_input_dim: int = 1024, goal_dim: int = 32, hidden: int = 512,
                 use_prev_action: bool = True, visual_is_map: bool = True,
                 scratch_cnn: bool = False, depth: bool = False, seed: int = 0):
        """`scratch_cnn` trains a ScratchCNN on raw frames and overrides
        `visual_is_map`. Weights are drawn as flax draws them, from a CPU generator
        seeded with `seed`, so every device gets the same ones."""
        super().__init__()
        if goal_kind not in GOAL_KINDS:
            raise ValueError(f"goal_kind {goal_kind!r} not in {GOAL_KINDS}")
        self.num_actions, self.goal_kind, self.hidden = num_actions, goal_kind, hidden
        self.use_prev_action, self.scratch_cnn = use_prev_action, scratch_cnn
        self.visual_is_map = visual_is_map
        extra = 1 if depth else 0
        with torch.device("meta"):
            if scratch_cnn:
                h, w, c = visual_shape
                self.scratch = ScratchCNN(c + extra, (h, w))
                width = 512
            elif visual_is_map:
                h, w, c = visual_shape
                self.compressor = VisualCompressor(c + extra)
                width = 32 * h * w
            else:
                (d,) = visual_shape
                self.visual_fc = nn.Linear(d, 512)
                width = 512
            if goal_kind == "object_embed":
                self.goal_embed = nn.Embedding(num_goal_classes, goal_dim)
            elif goal_kind in ("pointgoal", "text_embed"):
                self.goal_fc = nn.Linear(goal_input_dim, goal_dim)
            if goal_kind != "none":
                width += goal_dim
            if use_prev_action:
                # +1 slot: "no previous action" at episode starts.
                self.prev_action_embed = nn.Embedding(num_actions + 1, 6)
                width += 6
            self.gru = nn.GRUCell(width, hidden)
            self.actor = nn.Linear(hidden, num_actions)
            self.critic = nn.Linear(hidden, 1)
        self.to_empty(device="cpu")
        self.init_weights(torch.Generator().manual_seed(seed))
        rz = torch.ones(3 * hidden)
        rz[: 2 * hidden] = 0
        self.register_buffer("_bias_hh_grad_mask", rz, persistent=False)
        self.gru.bias_hh.register_hook(lambda g: g * self._bias_hh_grad_mask)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's defaults: truncated LeCun-normal kernels, zero biases, N(0, 1/features)
        embeddings, an orthogonal recurrent kernel per GRU gate."""
        def lecun(w: torch.Tensor, fan_in: int):
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)

        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                lecun(m.weight, m.weight[0].numel())
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, 0.0, m.weight.shape[1] ** -0.5, generator=generator)
        gru, h = self.gru, self.hidden
        for gate in range(3):
            lecun(gru.weight_ih[gate * h:(gate + 1) * h], gru.input_size)
            nn.init.orthogonal_(gru.weight_hh[gate * h:(gate + 1) * h], generator=generator)
        nn.init.zeros_(gru.bias_ih)
        nn.init.zeros_(gru.bias_hh)

    def initial_state(self, batch: int, device=None) -> torch.Tensor:
        return torch.zeros(batch, self.hidden, device=device)

    # -- unroll building blocks (see unroll_policy): only the GRU is recurrent, so
    # features and heads run batched over the flattened (T·B) sequence.

    def features(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        parts = []
        v = obs["visual"]
        if self.scratch_cnn:
            # RGBD: the depth channel joins the frames before the trainable CNN.
            if "depth" in obs:
                if v.dtype == torch.uint8:
                    v = v.float() / 255.0
                v = torch.cat([v.float(), obs["depth"].float()], -1)
            parts.append(self.scratch(v))
        elif self.visual_is_map:
            # RGBD with a frozen encoder: depth bypasses the encoder, resized to the
            # conv map's grid (antialiased linear, as jax.image.resize) and joined as
            # an extra channel of the compressor's input.
            if "depth" in obs:
                d = obs["depth"].float().permute(0, 3, 1, 2)
                d = F.interpolate(d, size=(v.shape[1], v.shape[2]), mode="bilinear",
                                  antialias=True, align_corners=False)
                v = torch.cat([v.float(), d.permute(0, 2, 3, 1)], -1)
            parts.append(self.compressor(v))
        else:
            parts.append(F.relu(self.visual_fc(v.float())))
        if self.goal_kind == "object_embed":
            parts.append(self.goal_embed(obs["goal"].long()))
        elif self.goal_kind in ("pointgoal", "text_embed"):
            g = obs["goal"].float()
            if self.goal_kind == "text_embed":
                g = g.detach()  # frozen text goals do not backprop into CLIP
            parts.append(self.goal_fc(g))
        if self.use_prev_action:
            parts.append(self.prev_action_embed(obs["prev_action"].long()))
        return torch.cat(parts, -1)

    def gru_step(self, x: torch.Tensor, h: torch.Tensor, done: torch.Tensor):
        """Hidden state zeroed where `done` (an episode starts), then one GRU step;
        returns (new hidden, output), which are the same tensor."""
        h = self.gru(x, torch.where(done[:, None], 0.0, h))
        return h, h

    def heads(self, out: torch.Tensor):
        return self.actor(out), self.critic(out)[..., 0]

    def forward(self, obs: Dict[str, torch.Tensor], h: torch.Tensor,
                done: Optional[torch.Tensor] = None):
        """Single step: (obs batch, hidden, episode starts) → (action logits, value, new
        hidden). The hidden state is zeroed where `done` BEFORE the step."""
        if done is None:
            done = torch.zeros(h.shape[0], dtype=torch.bool, device=h.device)
        h, out = self.gru_step(self.features(obs), h, done)
        logits, value = self.heads(out)
        return logits, value, h


def unroll_policy(policy: ActorCritic, obs_seq: Dict[str, torch.Tensor], h0: torch.Tensor,
                  done_seq: torch.Tensor):
    """Unroll over T steps: obs_seq of (T, B, ...), done_seq (T, B) episode starts.
    Returns (logits (T,B,A), values (T,B), hT). Features and heads run once over the
    flattened (T·B) batch; the GRU steps T times."""
    t, b = done_seq.shape
    x = policy.features({k: v.flatten(0, 1) for k, v in obs_seq.items()}).unflatten(0, (t, b))
    h, outs = h0, []
    for i in range(t):
        h, out = policy.gru_step(x[i], h, done_seq[i])
        outs.append(out)
    logits, values = policy.heads(torch.stack(outs).flatten(0, 1))
    return logits.unflatten(0, (t, b)), values.unflatten(0, (t, b)), h
