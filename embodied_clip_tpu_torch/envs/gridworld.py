"""Goal-conditioned grid navigation env, batched on torch tensors (port of
`embodied_clip_tpu/envs/gridworld.py`).

A hermetic ObjectNav analogue: egocentric observations, THOR's 6-action ObjectNav space
(MoveAhead / RotateLeft / RotateRight / LookUp / LookDown / End), a target object class
among distractors, shaped reward, success and SPL. The state is a dataclass of (B, ...)
tensors on one device; every method is batched tensor code, so a rollout never leaves
the device. `render_frames` / `frame_obs` emit uint8 RGB frames for the
frozen-encoder-in-the-rollout path.

Randomness goes through an explicit `torch.Generator` (its device is where episodes are
drawn). `step` is `advance` (deterministic) → `init_episodes` (the draws) → `auto_reset`;
the split lets a caller supply the fresh episodes itself.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["GridNavEnv", "GridNavState", "ACTIONS"]

ACTIONS = ("MoveAhead", "RotateLeft", "RotateRight", "LookUp", "LookDown", "End")
MOVE_AHEAD, ROTATE_LEFT, ROTATE_RIGHT, LOOK_UP, LOOK_DOWN, END = range(6)

# dir: 0=N(-y), 1=E(+x), 2=S(+y), 3=W(-x)
_DIR_VECS = ((-1, 0), (0, 1), (1, 0), (0, -1))
# Rotation matrices taking egocentric (forward, right) offsets to world (dy, dx).
_ROT = (((-1, 0), (0, 1)), ((0, 1), (1, 0)), ((1, 0), (0, -1)), ((0, -1), (-1, 0)))
# The JAX package renders with the float32 table jnp.linspace(0.1, 1.0, 12), which
# differs from torch.linspace (and numpy) in the last bit of 3 of its 12 entries; frames
# truncate to uint8, so a one-ulp difference can flip a byte. Its bits, as computed by
# XLA on the CPU:
_JAX_HUE_12 = np.array([1036831949, 1044000396, 1049033561, 1051778924, 1054524286,
                        1057117128, 1058489810, 1059862491, 1061235172, 1062607854,
                        1063980535, 1065353216], np.uint32).view(np.float32)


# Constant tables live on the device once: a host-to-device copy every step would make
# the host wait for the device.
@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    return (torch.tensor(_DIR_VECS, dtype=torch.int32, device=device),
            torch.tensor(_ROT, dtype=torch.int32, device=device))


@functools.lru_cache(maxsize=None)
def _hue(num_classes: int, device: torch.device) -> torch.Tensor:
    if num_classes == 12:
        table = _JAX_HUE_12
    else:  # jnp.linspace's formula in float32; JAX's table may differ in the last bit
        step = np.arange(num_classes - 1, dtype=np.float32) / np.float32(num_classes - 1)
        table = np.append(np.float32(0.1) * (1 - step) + step, np.float32(1.0))
    return torch.from_numpy(np.ascontiguousarray(table, np.float32)).to(device)


@functools.lru_cache(maxsize=None)
def _class_pool(classes: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    return torch.tensor(classes, dtype=torch.int32, device=device)


@dataclasses.dataclass
class GridNavState:
    agent_pos: torch.Tensor   # (B, 2) int32 (y, x)
    agent_dir: torch.Tensor   # (B,) int32
    agent_hor: torch.Tensor   # (B,) int32 camera horizon in {-1 (up), 0, 1 (down)}
    object_pos: torch.Tensor  # (B, K, 2) int32
    object_cls: torch.Tensor  # (B, K) int32
    target_idx: torch.Tensor  # (B,) int32: which object is the goal
    t: torch.Tensor           # (B,) int32 steps taken this episode
    start_dist: torch.Tensor  # (B,) int32 initial manhattan distance (for SPL)

    def replace(self, **kw) -> "GridNavState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class GridNavEnv:
    size: int = 8
    num_objects: int = 2
    num_classes: int = 12
    max_steps: int = 64
    view: int = 7              # egocentric window (view × view)
    success_dist: int = 1
    step_penalty: float = -0.01
    shaping: float = 0.2
    success_reward: float = 10.0
    # The egocentric view flattened to (B, view*view*C) instead of a conv map.
    flat_obs: bool = False
    # Restrict object classes to a subset (zero-shot seen/unseen splits). None = all.
    class_set: Optional[Tuple[int, ...]] = None
    # 'objectnav': goal = target class id. 'pointnav': goal = egocentric (distance,
    # heading) to the target, recomputed every step.
    task: str = "objectnav"
    # Emit uint8 RGB frames (render_frames) instead of the feature map.
    frame_obs: bool = False
    frame_cell_px: int = 8
    # Also emit a normalized egocentric depth map under obs['depth'] (1.0 outside the
    # scene), the RGBD observation of the habitat ddppo_*_rgbd baselines.
    depth_obs: bool = False

    @property
    def num_actions(self) -> int:
        return len(ACTIONS)

    @property
    def obs_channels(self) -> int:
        return self.num_classes + 1  # per-cell class one-hot + in-bounds

    # ----------------------------------------------------------------- episode init

    def init_episodes(self, batch: int, generator: torch.Generator) -> GridNavState:
        """`batch` fresh episodes drawn with `generator`, on its device: agent and
        objects uniform on the grid, distinct object classes (a random permutation of
        the class pool), a uniform target."""
        dev, g, i32 = generator.device, generator, torch.int32
        agent_pos = torch.randint(0, self.size, (batch, 2), generator=g, device=dev,
                                  dtype=i32)
        agent_dir = torch.randint(0, 4, (batch,), generator=g, device=dev, dtype=i32)
        object_pos = torch.randint(0, self.size, (batch, self.num_objects, 2),
                                   generator=g, device=dev, dtype=i32)
        pool = _class_pool(tuple(self.class_set if self.class_set is not None
                                 else range(self.num_classes)), dev)
        perm = torch.rand(batch, pool.shape[0], generator=g, device=dev).argsort(-1)
        idx = perm[:, torch.arange(self.num_objects, device=dev) % pool.shape[0]]
        target_idx = torch.randint(0, self.num_objects, (batch,), generator=g,
                                   device=dev, dtype=i32)
        tgt = object_pos[torch.arange(batch, device=dev), target_idx.long()]
        start_dist = (agent_pos - tgt).abs().sum(-1).clamp_min(1).to(i32)
        zeros = torch.zeros(batch, dtype=i32, device=dev)
        return GridNavState(agent_pos=agent_pos, agent_dir=agent_dir, agent_hor=zeros,
                            object_pos=object_pos, object_cls=pool[idx],
                            target_idx=target_idx, t=zeros.clone(),
                            start_dist=start_dist)

    def reset(self, generator: torch.Generator, batch: int
              ) -> Tuple[GridNavState, Dict[str, torch.Tensor]]:
        state = self.init_episodes(batch, generator)
        return state, self.observe(state)

    # ------------------------------------------------------------------ observation

    def _ego(self, device) -> torch.Tensor:
        """(v, v, 2) egocentric (forward, right) offsets; row 0 = farthest ahead."""
        r = self.view // 2
        fwd = torch.arange(self.view - 1, -1, -1, dtype=torch.int32, device=device) - r
        rgt = torch.arange(self.view, dtype=torch.int32, device=device) - r
        return torch.stack(torch.meshgrid(fwd, rgt, indexing="ij"), -1)

    def observe(self, s: GridNavState) -> Dict[str, torch.Tensor]:
        b, dev = s.agent_pos.shape[0], s.agent_pos.device
        dir_vecs, rot_table = _tables(dev)
        ego = self._ego(dev)
        rot = rot_table[s.agent_dir.long()]                              # (B,2,2)
        world = (ego[None, :, :, 0, None] * rot[:, None, None, 0, :]
                 + ego[None, :, :, 1, None] * rot[:, None, None, 1, :]
                 + s.agent_pos[:, None, None, :])                        # (B,v,v,2)
        # Camera pitch: looking up (hor=-1) shifts the window one cell farther ahead,
        # looking down (hor=+1) one cell closer.
        pitch = s.agent_hor[:, None] * dir_vecs[s.agent_dir.long()]
        world = world - pitch[:, None, None, :]
        in_bounds = ((world >= 0) & (world < self.size)).all(-1)          # (B,v,v)
        match = (world[:, :, :, None, :] == s.object_pos[:, None, None, :, :]).all(-1)
        match = match & in_bounds[..., None]                              # (B,v,v,K)
        onehot = torch.nn.functional.one_hot(s.object_cls.long(), self.num_classes)
        cls_map = (match[..., None] * onehot[:, None, None]).sum(3).float()
        visual = torch.cat([cls_map, in_bounds[..., None].float()], -1)
        depth = None
        if self.depth_obs:
            r = self.view // 2
            denom = np.float32(r) * np.sqrt(np.float32(2.0)) + np.float32(1e-6)
            cell_d = torch.linalg.vector_norm(ego.float(), dim=-1) / float(denom)
            depth = torch.where(in_bounds, cell_d[None], 1.0)[..., None]
        if self.frame_obs:
            visual = self._render(visual)
            if depth is not None:
                px = self.frame_cell_px
                depth = depth.repeat_interleave(px, 1).repeat_interleave(px, 2)
        elif self.flat_obs:
            visual = visual.reshape(b, -1)
        if self.task == "pointnav":
            d = (self._target_pos(s) - s.agent_pos).float()              # world (dy,dx)
            ego_goal = (d[:, None, :] * rot.float()).sum(-1)              # (fwd, right)
            dist = torch.linalg.vector_norm(d, dim=-1)
            heading = torch.atan2(ego_goal[:, 1], ego_goal[:, 0])
            goal = torch.stack([dist / self.size, heading], -1)
        else:
            goal = s.object_cls.gather(1, s.target_idx.long()[:, None])[:, 0]
        out = {"visual": visual, "goal": goal}
        if depth is not None:
            out["depth"] = depth
        return out

    def _render(self, visual_map: torch.Tensor) -> torch.Tensor:
        """(B,v,v,C) feature map → uint8 RGB frames."""
        c = self.num_classes
        r = (visual_map[..., :c] * _hue(c, visual_map.device)).sum(-1)
        g = visual_map[..., -1]  # in-bounds
        bl = visual_map[..., :c].sum(-1)
        img = torch.stack([r, 0.3 * g, bl], -1)  # (B,v,v,3) in [0,1]
        px = self.frame_cell_px
        img = img.repeat_interleave(px, 1).repeat_interleave(px, 2)
        return (img.clamp(0, 1) * 255).to(torch.uint8)

    def render_frames(self, s: GridNavState, cell_px: int = 8) -> torch.Tensor:
        """uint8 RGB frames of the egocentric view (for encoder-in-loop pipelines)."""
        env = dataclasses.replace(self, frame_obs=False, flat_obs=False,
                                  frame_cell_px=cell_px)
        return env._render(env.observe(s)["visual"])

    # ---------------------------------------------------------------------- expert

    def expert_action(self, s: GridNavState) -> torch.Tensor:
        """Greedy shortest-path oracle (End when within success_dist), int32 (B,)."""
        d = self._target_pos(s) - s.agent_pos      # (B,2) (dy, dx)
        dist = d.abs().sum(-1)
        want_y = d[:, 0].abs() >= d[:, 1].abs()
        dir_y = torch.where(d[:, 0] < 0, 0, 2)     # N or S
        dir_x = torch.where(d[:, 1] > 0, 1, 3)     # E or W
        desired = torch.where(want_y & (d[:, 0] != 0), dir_y,
                              torch.where(d[:, 1] != 0, dir_x, dir_y))
        diff = torch.remainder(desired - s.agent_dir, 4)
        turn = torch.where(diff == 1, ROTATE_RIGHT,
                           torch.where(diff == 3, ROTATE_LEFT, ROTATE_RIGHT))
        move_or_turn = torch.where(diff == 0, MOVE_AHEAD, turn)
        return torch.where(dist <= self.success_dist, END, move_or_turn).to(torch.int32)

    # ------------------------------------------------------------------------ step

    def _target_pos(self, s: GridNavState) -> torch.Tensor:
        idx = s.target_idx.long()[:, None, None].expand(-1, 1, 2)
        return s.object_pos.gather(1, idx)[:, 0]

    def _dist(self, s: GridNavState) -> torch.Tensor:
        return (s.agent_pos - self._target_pos(s)).abs().sum(-1)

    def advance(self, s: GridNavState, action: torch.Tensor):
        """(state, actions (B,)) → (stepped state, reward (B,), done (B,), info): the
        deterministic part of a step, before finished episodes are replaced. info holds
        per-step `success`, `spl`, `episode_len` (valid where done) and `done`, f32."""
        dir_vecs, _ = _tables(s.agent_pos.device)
        d_prev = self._dist(s)
        moved = (s.agent_pos + dir_vecs[s.agent_dir.long()]).clamp(0, self.size - 1)
        new_pos = torch.where((action == MOVE_AHEAD)[:, None], moved, s.agent_pos)
        new_dir = torch.remainder(s.agent_dir
                                  + torch.where(action == ROTATE_LEFT, -1, 0)
                                  + torch.where(action == ROTATE_RIGHT, 1, 0), 4)
        new_hor = (s.agent_hor + torch.where(action == LOOK_UP, -1, 0)
                   + torch.where(action == LOOK_DOWN, 1, 0)).clamp(-1, 1)
        i32 = torch.int32
        stepped = s.replace(agent_pos=new_pos.to(i32), agent_dir=new_dir.to(i32),
                            agent_hor=new_hor.to(i32), t=s.t + 1)

        d_new = self._dist(stepped)
        success = (action == END) & (d_new <= self.success_dist)
        done = (action == END) | (stepped.t >= self.max_steps)
        reward = (self.step_penalty
                  + self.shaping * (d_prev - d_new).float()
                  + self.success_reward * success.float())
        ep_len = stepped.t.float()
        start = s.start_dist.float()
        spl = success.float() * (start / torch.maximum(ep_len, start))
        info = {"success": success.float(), "spl": spl, "episode_len": ep_len,
                "done": done.float()}
        return stepped, reward, done, info

    @staticmethod
    def auto_reset(stepped: GridNavState, done: torch.Tensor,
                   fresh: GridNavState) -> GridNavState:
        """`fresh`'s episode where `done`, `stepped`'s elsewhere."""
        def sel(a, b):
            return torch.where(done.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)

        return GridNavState(**{f.name: sel(getattr(fresh, f.name), getattr(stepped, f.name))
                               for f in dataclasses.fields(GridNavState)})

    def step(self, s: GridNavState, action: torch.Tensor, generator: torch.Generator):
        """(state, actions (B,)) → (state', obs, reward (B,), done (B,), info).

        Finished episodes are replaced by fresh ones drawn with `generator` (the
        returned obs is the first of the new episode where done)."""
        stepped, reward, done, info = self.advance(s, action)
        fresh = self.init_episodes(s.t.shape[0], generator)
        new_state = self.auto_reset(stepped, done, fresh)
        return new_state, self.observe(new_state), reward, done, info
