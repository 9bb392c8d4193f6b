"""Rearrangement envs (pick → carry → place), 1-phase and 2-phase, batched on torch
tensors (port of `embodied_clip_tpu/envs/rearrange.py`).

The fake-env analogue of the reference's iTHOR Rearrangement suite
(baselines_ithor_rearrangement.md:4-12). 1-phase (`GridRearrangeEnv`, trained with
DAgger): one misplaced object must be picked up at its current cell and dropped at its
goal cell, with the goal cell visible throughout. 2-phase (`GridTwoPhaseRearrangeEnv`):
the agent first observes the scene in its goal configuration (the object on its goal
cell, the goal channel lit), ends the walkthrough with Drop (or exhausts the budget);
then the object and the agent teleport to random cells and the goal channel goes dark,
so the unshuffle phase is solved from the GRU's memory. obs["goal"] carries the phase.

Actions: MoveAhead, RotateLeft, RotateRight, Pickup, Drop. Success: Drop while holding
within success_dist of the goal cell. Metrics: success, "spl"-style efficiency
(shortest pick+place path over steps taken), episode_len, done.

As in `envs/gridworld.py`, the state holds no key: randomness comes from a
`torch.Generator` (on the device where episodes are drawn), and `step` is `advance`
(deterministic) → `init_episodes` (the draws) → `auto_reset`. The 2-phase `advance`
also takes the phase switch's teleports (`draw_shuffle`), so a caller can supply every
draw itself.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from embodied_clip_tpu_torch.envs.gridworld import _tables

__all__ = ["GridRearrangeEnv", "GridRearrangeState", "GridTwoPhaseRearrangeEnv",
           "GridTwoPhaseState", "REARRANGE_ACTIONS"]

REARRANGE_ACTIONS = ("MoveAhead", "RotateLeft", "RotateRight", "Pickup", "Drop")
MOVE_AHEAD, ROTATE_LEFT, ROTATE_RIGHT, PICKUP, DROP = range(5)


@dataclasses.dataclass
class GridRearrangeState:
    agent_pos: torch.Tensor   # (B, 2) int32
    agent_dir: torch.Tensor   # (B,) int32
    obj_pos: torch.Tensor     # (B, 2) current object cell (ignored while held)
    goal_pos: torch.Tensor    # (B, 2) target cell
    holding: torch.Tensor     # (B,) bool
    t: torch.Tensor           # (B,) int32
    best_len: torch.Tensor    # (B,) shortest pick+place path length (for efficiency)

    def replace(self, **kw) -> "GridRearrangeState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class GridTwoPhaseState:
    agent_pos: torch.Tensor   # (B, 2) int32
    agent_dir: torch.Tensor   # (B,) int32
    obj_pos: torch.Tensor     # (B, 2) current object cell (= goal during the walkthrough)
    goal_pos: torch.Tensor    # (B, 2) target cell
    holding: torch.Tensor     # (B,) bool
    t: torch.Tensor           # (B,) unshuffle-phase step count
    walk_t: torch.Tensor      # (B,) walkthrough-phase step count
    phase: torch.Tensor       # (B,) int32: 0 = walkthrough, 1 = unshuffle
    best_len: torch.Tensor    # (B,) shortest pick+place path (set at the phase switch)

    def replace(self, **kw) -> "GridTwoPhaseState":
        return dataclasses.replace(self, **kw)


def _select(state_cls, done: torch.Tensor, fresh, stepped):
    """`fresh`'s episode where `done`, `stepped`'s elsewhere."""
    def sel(a, b):
        return torch.where(done.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)

    return state_cls(**{f.name: sel(getattr(fresh, f.name), getattr(stepped, f.name))
                        for f in dataclasses.fields(state_cls)})


def _randint(generator: torch.Generator, high: int, *shape) -> torch.Tensor:
    return torch.randint(0, high, shape, generator=generator, device=generator.device,
                         dtype=torch.int32)


class _GridRearrangeBase:
    """Observation, expert and navigation shared by both envs."""

    size: int
    view: int
    success_dist: int
    flat_obs: bool

    @property
    def num_actions(self) -> int:
        return len(REARRANGE_ACTIONS)

    @property
    def obs_channels(self) -> int:
        # in-bounds, object-here, goal-here, holding flag (broadcast)
        return 4

    def _cells(self, s) -> Tuple[torch.Tensor, torch.Tensor]:
        """World cells of the egocentric view (B, v, v, 2) and their in-bounds mask."""
        dev = s.agent_pos.device
        _, rot_table = _tables(dev)
        r = self.view // 2
        fwd = torch.arange(self.view - 1, -1, -1, dtype=torch.int32, device=dev) - r
        rgt = torch.arange(self.view, dtype=torch.int32, device=dev) - r
        ego = torch.stack(torch.meshgrid(fwd, rgt, indexing="ij"), -1)
        rot = rot_table[s.agent_dir.long()]
        world = (ego[None, :, :, 0, None] * rot[:, None, None, 0, :]
                 + ego[None, :, :, 1, None] * rot[:, None, None, 1, :]
                 + s.agent_pos[:, None, None, :])
        in_b = ((world >= 0) & (world < self.size)).all(-1).float()
        return world, in_b

    def _visual(self, s, goal_lit: torch.Tensor) -> torch.Tensor:
        world, in_b = self._cells(s)
        obj_here = (((world == s.obj_pos[:, None, None, :]).all(-1)
                     & ~s.holding[:, None, None]).float() * in_b)
        goal_here = ((world == s.goal_pos[:, None, None, :]).all(-1).float() * in_b
                     * goal_lit[:, None, None])
        hold = s.holding[:, None, None].float().expand_as(in_b)
        visual = torch.stack([in_b, obj_here, goal_here, hold], -1)
        if self.flat_obs:
            visual = visual.reshape(visual.shape[0], -1)
        return visual

    def _greedy(self, s, target: torch.Tensor, interact: torch.Tensor) -> torch.Tensor:
        """Walk to `target` (turn toward the larger axis gap first), `interact` there."""
        d = target - s.agent_pos
        at_target = d.abs().sum(-1) <= self.success_dist
        want_y = d[:, 0].abs() >= d[:, 1].abs()
        dir_y = torch.where(d[:, 0] < 0, 0, 2)
        dir_x = torch.where(d[:, 1] > 0, 1, 3)
        desired = torch.where(want_y & (d[:, 0] != 0), dir_y,
                              torch.where(d[:, 1] != 0, dir_x, dir_y))
        diff = torch.remainder(desired - s.agent_dir, 4)
        turn = torch.where(diff == 3, ROTATE_LEFT, ROTATE_RIGHT)
        move = torch.where(diff == 0, MOVE_AHEAD, turn)
        return torch.where(at_target, interact, move).to(torch.int32)

    def _navigate(self, s, action: torch.Tensor):
        """(new agent cell, new heading) after `action`'s move or turn."""
        dir_vecs, _ = _tables(s.agent_pos.device)
        moved = (s.agent_pos + dir_vecs[s.agent_dir.long()]).clamp(0, self.size - 1)
        new_pos = torch.where((action == MOVE_AHEAD)[:, None], moved, s.agent_pos)
        new_dir = torch.remainder(s.agent_dir
                                  + torch.where(action == ROTATE_LEFT, -1, 0)
                                  + torch.where(action == ROTATE_RIGHT, 1, 0), 4)
        return new_pos, new_dir


@dataclasses.dataclass(frozen=True)
class GridRearrangeEnv(_GridRearrangeBase):
    size: int = 8
    max_steps: int = 96
    view: int = 7
    success_dist: int = 1
    step_penalty: float = -0.01
    shaping: float = 0.2
    pickup_reward: float = 2.0
    success_reward: float = 10.0
    flat_obs: bool = False

    def init_episodes(self, batch: int, generator: torch.Generator) -> GridRearrangeState:
        """`batch` fresh episodes drawn with `generator`: agent, object and goal cells
        uniform on the grid, a uniform heading."""
        agent = _randint(generator, self.size, batch, 2)
        agent_dir = _randint(generator, 4, batch)
        obj = _randint(generator, self.size, batch, 2)
        goal = _randint(generator, self.size, batch, 2)
        best = ((agent - obj).abs().sum(-1) + (obj - goal).abs().sum(-1)).clamp_min(1)
        zeros = torch.zeros(batch, dtype=torch.int32, device=agent.device)
        return GridRearrangeState(agent_pos=agent, agent_dir=agent_dir, obj_pos=obj,
                                  goal_pos=goal, holding=zeros.bool(), t=zeros,
                                  best_len=best.to(torch.int32))

    def reset(self, generator: torch.Generator, batch: int
              ) -> Tuple[GridRearrangeState, Dict[str, torch.Tensor]]:
        state = self.init_episodes(batch, generator)
        return state, self.observe(state)

    def observe(self, s: GridRearrangeState) -> Dict[str, torch.Tensor]:
        lit = torch.ones(s.agent_dir.shape[0], device=s.agent_dir.device)
        return {"visual": self._visual(s, lit),
                "goal": torch.zeros_like(s.agent_dir)}

    def expert_action(self, s: GridRearrangeState) -> torch.Tensor:
        """Greedy two-stage oracle: go to the object → Pickup; go to the goal → Drop."""
        target = torch.where(s.holding[:, None], s.goal_pos, s.obj_pos)
        return self._greedy(s, target, torch.where(s.holding, DROP, PICKUP))

    def advance(self, s: GridRearrangeState, action: torch.Tensor):
        """(state, actions (B,)) → (stepped state, reward, done, info), before finished
        episodes are replaced."""
        target = torch.where(s.holding[:, None], s.goal_pos, s.obj_pos)
        d_prev = (target - s.agent_pos).abs().sum(-1)
        new_pos, new_dir = self._navigate(s, action)

        near_obj = (s.obj_pos - new_pos).abs().sum(-1) <= self.success_dist
        pickup_ok = (action == PICKUP) & ~s.holding & near_obj
        new_holding = s.holding | pickup_ok
        near_goal = (s.goal_pos - new_pos).abs().sum(-1) <= self.success_dist
        success = (action == DROP) & s.holding & near_goal
        # An off-target Drop puts the object at the agent's cell.
        dropped_off = (action == DROP) & s.holding & ~near_goal
        new_obj = torch.where(dropped_off[:, None], new_pos, s.obj_pos)
        new_holding = new_holding & ~(action == DROP)

        i32 = torch.int32
        stepped = s.replace(agent_pos=new_pos.to(i32), agent_dir=new_dir.to(i32),
                            obj_pos=new_obj.to(i32), holding=new_holding, t=s.t + 1)
        target2 = torch.where(stepped.holding[:, None], stepped.goal_pos, stepped.obj_pos)
        d_new = (target2 - stepped.agent_pos).abs().sum(-1)
        done = success | (stepped.t >= self.max_steps)

        shaping_delta = torch.where(s.holding == stepped.holding,
                                    (d_prev - d_new).float(), 0.0)
        reward = (self.step_penalty + self.shaping * shaping_delta
                  + self.pickup_reward * pickup_ok.float()
                  + self.success_reward * success.float())
        ep_len = stepped.t.float()
        best = s.best_len.float()
        eff = success.float() * (best / torch.maximum(ep_len, best))
        info = {"success": success.float(), "spl": eff, "episode_len": ep_len,
                "done": done.float()}
        return stepped, reward, done, info

    @staticmethod
    def auto_reset(stepped: GridRearrangeState, done: torch.Tensor,
                   fresh: GridRearrangeState) -> GridRearrangeState:
        return _select(GridRearrangeState, done, fresh, stepped)

    def step(self, s: GridRearrangeState, action: torch.Tensor, generator: torch.Generator):
        """(state, actions (B,)) → (state', obs, reward (B,), done (B,), info); finished
        episodes are replaced by fresh ones drawn with `generator`."""
        stepped, reward, done, info = self.advance(s, action)
        new_state = self.auto_reset(stepped, done,
                                    self.init_episodes(s.t.shape[0], generator))
        return new_state, self.observe(new_state), reward, done, info


@dataclasses.dataclass(frozen=True)
class GridTwoPhaseRearrangeEnv(_GridRearrangeBase):
    """2-phase walkthrough → unshuffle rearrangement (see the module docstring).

    Phase 0: the object sits on its goal cell and the goal channel is lit; only
    navigation acts (Pickup is inert; Drop ends the walkthrough, as does the budget).
    Phase switch: the object and the agent teleport, the goal channel goes dark. Phase 1:
    the 1-phase dynamics, solved from memory. obs["goal"] = phase (num_classes = 2)."""

    size: int = 8
    max_steps: int = 96
    walkthrough_budget: int = 24
    view: int = 7
    success_dist: int = 1
    step_penalty: float = -0.01
    shaping: float = 0.2
    pickup_reward: float = 2.0
    success_reward: float = 10.0
    flat_obs: bool = False
    num_classes: int = 2  # the phase flag rides the goal embedding

    def init_episodes(self, batch: int, generator: torch.Generator) -> GridTwoPhaseState:
        """`batch` fresh episodes in the walkthrough phase: the scene in its goal
        configuration (the object on its goal cell)."""
        agent = _randint(generator, self.size, batch, 2)
        goal = _randint(generator, self.size, batch, 2)
        agent_dir = _randint(generator, 4, batch)
        zeros = torch.zeros(batch, dtype=torch.int32, device=agent.device)
        return GridTwoPhaseState(agent_pos=agent, agent_dir=agent_dir, obj_pos=goal,
                                 goal_pos=goal.clone(), holding=zeros.bool(), t=zeros,
                                 walk_t=zeros.clone(), phase=zeros.clone(),
                                 best_len=torch.ones_like(zeros))

    def draw_shuffle(self, batch: int, generator: torch.Generator):
        """The phase switch's teleports: (object cell, agent cell, agent heading)."""
        return (_randint(generator, self.size, batch, 2),
                _randint(generator, self.size, batch, 2), _randint(generator, 4, batch))

    def reset(self, generator: torch.Generator, batch: int
              ) -> Tuple[GridTwoPhaseState, Dict[str, torch.Tensor]]:
        state = self.init_episodes(batch, generator)
        return state, self.observe(state)

    def observe(self, s: GridTwoPhaseState) -> Dict[str, torch.Tensor]:
        # the goal channel is lit only during the walkthrough
        return {"visual": self._visual(s, (s.phase == 0).float()),
                "goal": s.phase.to(torch.int32)}

    def expert_action(self, s: GridTwoPhaseState) -> torch.Tensor:
        """Walkthrough: walk to the goal cell (gathering what the unshuffle labels rely
        on), then Drop to end the phase. Unshuffle: the 1-phase greedy oracle."""
        is_walk = s.phase == 0
        target = torch.where(is_walk[:, None], s.goal_pos,
                             torch.where(s.holding[:, None], s.goal_pos, s.obj_pos))
        return self._greedy(s, target, torch.where(is_walk | s.holding, DROP, PICKUP))

    def advance(self, s: GridTwoPhaseState, action: torch.Tensor, shuffle):
        """(state, actions (B,), `draw_shuffle`'s teleports) → (stepped state, reward,
        done, info), before finished episodes are replaced."""
        shuf_obj, shuf_agent, shuf_dir = shuffle
        is_walk = s.phase == 0
        target = torch.where(s.holding[:, None], s.goal_pos, s.obj_pos)
        d_prev = (target - s.agent_pos).abs().sum(-1)
        new_pos, new_dir = self._navigate(s, action)

        # interactions act only in the unshuffle phase
        near_obj = (s.obj_pos - new_pos).abs().sum(-1) <= self.success_dist
        pickup_ok = (action == PICKUP) & ~s.holding & near_obj & ~is_walk
        new_holding = s.holding | pickup_ok
        near_goal = (s.goal_pos - new_pos).abs().sum(-1) <= self.success_dist
        success = (action == DROP) & s.holding & near_goal & ~is_walk
        dropped_off = (action == DROP) & s.holding & ~near_goal & ~is_walk
        new_obj = torch.where(dropped_off[:, None], new_pos, s.obj_pos)
        new_holding = new_holding & ~(action == DROP)

        # walkthrough → unshuffle: Drop ends the phase, the budget forces it
        new_walk_t = torch.where(is_walk, s.walk_t + 1, s.walk_t)
        end_walk = is_walk & ((action == DROP) | (new_walk_t >= self.walkthrough_budget))
        best = ((shuf_agent - shuf_obj).abs().sum(-1)
                + (shuf_obj - s.goal_pos).abs().sum(-1))
        ew = end_walk[:, None]
        i32 = torch.int32
        stepped = s.replace(
            agent_pos=torch.where(ew, shuf_agent, new_pos).to(i32),
            agent_dir=torch.where(end_walk, shuf_dir, new_dir).to(i32),
            obj_pos=torch.where(ew, shuf_obj, new_obj).to(i32),
            holding=new_holding & ~end_walk,
            t=torch.where(is_walk, s.t, s.t + 1),
            walk_t=new_walk_t,
            phase=torch.where(end_walk, 1, s.phase).to(i32),
            best_len=torch.where(end_walk, best.clamp_min(1), s.best_len).to(i32))

        target2 = torch.where(stepped.holding[:, None], stepped.goal_pos, stepped.obj_pos)
        d_new = (target2 - stepped.agent_pos).abs().sum(-1)
        done = success | ((stepped.phase == 1) & (stepped.t >= self.max_steps))

        # rewarded only in the unshuffle phase (the walkthrough is unrewarded exploration)
        shaping_delta = torch.where((s.holding == stepped.holding) & ~is_walk & ~end_walk,
                                    (d_prev - d_new).float(), 0.0)
        reward = torch.where(is_walk, 0.0,
                             self.step_penalty + self.shaping * shaping_delta
                             + self.pickup_reward * pickup_ok.float()
                             + self.success_reward * success.float())
        ep_len = stepped.t.float()
        best_f = stepped.best_len.float()
        eff = success.float() * (best_f / torch.maximum(ep_len, best_f))
        info = {"success": success.float(), "spl": eff, "episode_len": ep_len,
                "done": done.float()}
        return stepped, reward, done, info

    @staticmethod
    def auto_reset(stepped: GridTwoPhaseState, done: torch.Tensor,
                   fresh: GridTwoPhaseState) -> GridTwoPhaseState:
        return _select(GridTwoPhaseState, done, fresh, stepped)

    def step(self, s: GridTwoPhaseState, action: torch.Tensor, generator: torch.Generator):
        """(state, actions (B,)) → (state', obs, reward (B,), done (B,), info); the phase
        switch's teleports and the fresh episodes are drawn with `generator`."""
        b = s.t.shape[0]
        stepped, reward, done, info = self.advance(s, action, self.draw_shuffle(b, generator))
        new_state = self.auto_reset(stepped, done, self.init_episodes(b, generator))
        return new_state, self.observe(new_state), reward, done, info
