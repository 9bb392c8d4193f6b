"""The RL experiment registry (port of `embodied_clip_tpu/config/rl_experiments.py`), so
far only its goal wrapper: `_GoalMappedEnv` (`rl_experiments.py:847-861`), which the
zero-shot experiments put around the on-device env so that the rollout stores and the
policy reads CLIP text-goal embeddings (`zeroshot.goal_map_fn`) in place of class ids
(`rl_experiments.py:333,349-351`). The registry itself is still to be ported.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["_GoalMappedEnv"]


class _GoalMappedEnv:
    """Wrap a batched on-device env (`reset(generator, batch)`, `step(state, action,
    generator)`) so integer goals come out as embedding vectors."""

    def __init__(self, inner, goal_map: Callable):
        self.inner = inner
        self.goal_map = goal_map

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def reset(self, generator, batch: int):
        state, obs = self.inner.reset(generator, batch)
        return state, {**obs, "goal": self.goal_map(obs["goal"])}

    def step(self, state, action, generator):
        state, obs, r, d, info = self.inner.step(state, action, generator)
        return state, {**obs, "goal": self.goal_map(obs["goal"])}, r, d, info
