"""Habitat ObjectNav/PointNav adapter — a HostEnv over habitat-lab (port of
`embodied_clip_tpu/envs/habitat.py`).

Behavioral spec from the reference's habitat fork runbooks (baselines_habitat.md:
63-97): ObjectNav on MP3D and PointNav on Gibson, RGB (or RGBD) observations, DD-PPO
training, eval reporting success/SPL. The adapter exposes habitat's own task/reward
machinery through the HostEnv contract; goal is the object-category id (ObjectNav) or
the polar pointgoal-with-gps-compass vector (PointNav), matching the policy's
`object_embed` / `pointgoal` conditioning.

Without habitat-lab/habitat-sim, construction raises with instructions; the hermetic
stand-in is envs/host_gridworld.py, and `env_factory` takes a habitat.Env-compatible
object.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from embodied_clip_tpu_torch.envs.base import HostEnv

__all__ = ["HabitatNavEnv"]


class HabitatNavEnv(HostEnv):
    # habitat-baselines NavRLEnv reward constants (the fork's RL.SLACK_REWARD /
    # RL.SUCCESS_REWARD defaults the reference's DD-PPO baselines train with).
    SLACK_REWARD = -0.01
    SUCCESS_REWARD = 2.5

    @staticmethod
    def nav_reward(prev_distance: float, distance: float, success: float) -> float:
        """habitat-baselines NavRLEnv.get_reward: slack + geodesic
        distance-to-goal delta + success bonus."""
        return (HabitatNavEnv.SLACK_REWARD
                + (prev_distance - distance)
                + HabitatNavEnv.SUCCESS_REWARD * success)

    def __init__(self, config_path: str, task: str = "objectnav",
                 rgb_only: bool = True, max_steps: int = 500, seed: int = 0,
                 env_factory=None, split: Optional[str] = None):
        # env_factory: inject a habitat.Env-compatible object (tests use a scripted
        # fake, tests/fake_habitat.py, to pin obs mapping / reward / metrics without
        # habitat-sim).
        # split: override the yaml's DATASET.SPLIT — checkpoint eval runs on
        # 'val' (the reference's --run-type eval contract,
        # baselines_habitat.md:88-97) while the yaml defaults to train.
        if env_factory is None:
            try:
                import habitat
            except ImportError as e:
                raise ImportError(
                    "habitat-lab + habitat-sim are required for HabitatNavEnv "
                    "(see the reference's install runbook, baselines_habitat.md). "
                    "For hermetic runs use envs.host_gridworld.HostGridNav."
                ) from e

            def env_factory(path, split=None):
                cfg = habitat.get_config(path)
                if split:
                    cfg.defrost()
                    cfg.DATASET.SPLIT = split
                    cfg.freeze()
                return habitat.Env(config=cfg)
        # Decide by signature whether the factory takes split= — a blanket
        # except-TypeError would swallow real TypeErrors raised INSIDE the
        # factory (running it twice, leaking a half-built simulator) and,
        # worse, silently drop a requested val split so "eval" would score
        # the yaml's train scenes.
        import inspect

        try:
            sig = inspect.signature(env_factory)
            takes_split = "split" in sig.parameters or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in sig.parameters.values())
        except (TypeError, ValueError):
            takes_split = True  # uninspectable: assume the documented 2-arg shape
        if takes_split:
            self.env = env_factory(config_path, split=split)
        elif split is None:
            self.env = env_factory(config_path)
        else:
            raise TypeError(
                f"env_factory {env_factory!r} takes no split= argument but "
                f"split={split!r} was requested; a path-only factory cannot "
                "honor the eval-split contract (baselines_habitat.md:88-97)")
        self.env.seed(seed)
        self.task = task
        self.rgb_only = rgb_only
        self.max_steps = max_steps
        # habitat-lab ObjectNav/PointNav action spaces both start with STOP.
        self.num_actions = len(self.env.action_space.spaces) \
            if hasattr(self.env.action_space, "spaces") else self.env.action_space.n
        self._t = 0
        self._start_geodesic = 1.0

    def _obs(self, habitat_obs) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {
            "visual": np.asarray(habitat_obs["rgb"], dtype=np.uint8)
        }
        if not self.rgb_only and "depth" in habitat_obs:
            out["depth"] = np.asarray(habitat_obs["depth"], dtype=np.float32)
        if self.task == "objectnav":
            out["goal"] = np.int32(habitat_obs["objectgoal"][0])
        else:
            out["goal"] = np.asarray(
                habitat_obs["pointgoal_with_gps_compass"], dtype=np.float32
            )
        return out

    def reset(self) -> Dict[str, np.ndarray]:
        obs = self.env.reset()
        self._t = 0
        m = self.env.get_metrics()
        self._start_geodesic = max(float(m.get("distance_to_goal", 1.0)), 1e-3)
        # Same fallback as _start_geodesic: if the metric is absent at reset, the
        # first step must not see a spurious (0 - d) geodesic delta.
        self._prev_distance = float(m.get("distance_to_goal", self._start_geodesic))
        return self._obs(obs)

    def step(self, action: int) -> Tuple[Dict[str, np.ndarray], float, bool, Dict[str, Any]]:
        obs = self.env.step(action)
        self._t += 1
        m = self.env.get_metrics()
        done = self.env.episode_over or self._t >= self.max_steps
        success = float(m.get("success", 0.0))
        # The reward the reference's habitat DD-PPO baselines train with
        # (baselines_habitat.md:63-75).
        distance = float(m.get("distance_to_goal", self._prev_distance))
        reward = self.nav_reward(self._prev_distance, distance, success)
        self._prev_distance = distance
        info: Dict[str, Any] = {}
        if done:
            info = {
                "success": success,
                "spl": float(m.get("spl", 0.0)),
                "episode_len": float(self._t),
            }
            return self.reset(), reward, True, info
        return self._obs(obs), reward, False, info

    def close(self) -> None:
        self.env.close()
