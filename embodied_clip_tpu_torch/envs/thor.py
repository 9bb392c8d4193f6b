"""AI2-THOR ObjectNav adapter (RoboTHOR/iTHOR), a HostEnv over ai2thor.Controller (port
of `embodied_clip_tpu/envs/thor.py`).

Behavioral spec from the reference: THOR driven via ai2thor.Controller with discrete
actions and RGB frames (thor_frames.py:25-36, 66-86); RoboTHOR ObjectNav success =
agent issues End while the target object is visible within 1.0m, metrics success +
SPL (readme_files/zeroshot_objectnav.md:36-47); 12-class target vocabulary
(constants.ROBOTHOR_OBJECT_TYPES). Runs on CPU hosts inside VectorEnv workers; frames
are encoded on the card.

Without ai2thor, construction raises with instructions; the hermetic stand-in is
envs/host_gridworld.py, and `controller_factory` takes a Controller-compatible object.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from embodied_clip_tpu_torch.constants import OBJECTNAV_ACTIONS, ROBOTHOR_OBJECT_TYPES
from embodied_clip_tpu_torch.envs.base import HostEnv

__all__ = ["THORObjectNavEnv", "OBJECTNAV_ACTIONS"]


class THORObjectNavEnv(HostEnv):
    num_actions = len(OBJECTNAV_ACTIONS)

    def __init__(self, scenes: Sequence[str], object_types: Sequence[str] = tuple(ROBOTHOR_OBJECT_TYPES),
                 width: int = 300, height: int = 300, fov: float = 90.0,
                 grid_size: float = 0.25, rotate_degrees: float = 30.0,
                 max_steps: int = 500, visibility_distance: float = 1.0,
                 shaping: float = 0.0,
                 seed: int = 0, controller_kwargs: Optional[Dict] = None,
                 controller_factory=None):
        # controller_factory: inject a Controller-compatible object (tests use a
        # scripted fake controller, tests/fake_thor.py, to pin the adapter's call
        # signatures and metrics without the Unity binary).
        if controller_factory is None:
            try:
                from ai2thor.controller import Controller
            except ImportError as e:
                raise ImportError(
                    "ai2thor is required for THORObjectNavEnv (pip install ai2thor; "
                    "headless hosts need an X display or a headless THOR build). "
                    "For hermetic runs use envs.host_gridworld.HostGridNav."
                ) from e
            controller_factory = Controller

        self.controller = controller_factory(
            gridSize=grid_size, rotateStepDegrees=rotate_degrees,
            width=width, height=height, fieldOfView=fov,
            visibilityDistance=visibility_distance,
            **(controller_kwargs or {}),
        )
        self.scenes = list(scenes)
        self.object_types = list(object_types)
        self.max_steps = max_steps
        self.shaping = shaping
        self.rng = random.Random(seed)
        self._episode: Dict[str, Any] = {}

    # --------------------------------------------------------------------- helpers

    def _visible_target(self) -> bool:
        for obj in self.controller.last_event.metadata["objects"]:
            if (obj["objectType"] == self._episode["object_type"]
                    and obj.get("visible", False)):
                return True
        return False

    def _geodesic_to_target(self) -> float:
        """Shortest-path length to the nearest target instance (for SPL); falls back
        to euclidean when the path query fails, and to 0.0 when the scene holds
        no instance of the target type at all — inf here would turn SPL into
        0*inf/inf = NaN and each shaping reward into (inf - inf) = NaN, which
        propagates through GAE into the whole param tree."""
        meta = self.controller.last_event.metadata
        pos = meta["agent"]["position"]
        best = np.inf
        for obj in meta["objects"]:
            if obj["objectType"] != self._episode["object_type"]:
                continue
            try:
                ev = self.controller.step(
                    action="GetShortestPathToPoint",
                    position=pos, x=obj["position"]["x"],
                    y=obj["position"]["y"], z=obj["position"]["z"],
                )
                corners = ev.metadata["actionReturn"]["corners"]
                d = sum(
                    np.hypot(b["x"] - a["x"], b["z"] - a["z"])
                    for a, b in zip(corners, corners[1:])
                )
            except Exception:
                o = obj["position"]
                d = np.hypot(o["x"] - pos["x"], o["z"] - pos["z"])
            best = min(best, d)
        return float(best) if np.isfinite(best) else 0.0

    def _obs(self, event=None) -> Dict[str, np.ndarray]:
        # Metadata queries (_geodesic_to_target) issue controller.step calls that
        # replace last_event, so the acting step's event must be captured explicitly.
        event = event if event is not None else self.controller.last_event
        frame = np.asarray(event.frame, dtype=np.uint8)
        goal = np.int32(self.object_types.index(self._episode["object_type"]))
        return {"visual": frame, "goal": goal}

    # ------------------------------------------------------------------- lifecycle

    def reset(self) -> Dict[str, np.ndarray]:
        scene = self.rng.choice(self.scenes)
        self.controller.reset(scene=scene)
        present = {
            o["objectType"] for o in self.controller.last_event.metadata["objects"]
        }
        candidates = [t for t in self.object_types if t in present] or self.object_types
        self._episode = {
            "object_type": self.rng.choice(candidates),
            "t": 0,
        }
        # Randomize the start pose over reachable positions (thor_frames.py:52-59).
        ev = self.controller.step(action="GetReachablePositions")
        locations = ev.metadata.get("actionReturn") or []
        if locations:
            pos = self.rng.choice(locations)
            self.controller.step(
                action="TeleportFull", position=pos,
                rotation=dict(x=0, y=self.rng.choice([0, 90, 180, 270]), z=0),
                horizon=0, standing=True,
            )
        event = self.controller.last_event
        self._episode["start_geodesic"] = max(self._geodesic_to_target(), 1e-3)
        self._episode["path_len"] = 0.0
        self._episode["last_geodesic"] = self._episode["start_geodesic"]
        return self._obs(event)

    def step(self, action: int) -> Tuple[Dict[str, np.ndarray], float, bool, Dict[str, Any]]:
        name = OBJECTNAV_ACTIONS[action]
        self._episode["t"] += 1
        done, success = False, False
        if name == "End":
            done = True
            # RoboTHOR ObjectNav success (allenact ObjectNavTask): agent issues End
            # while a target instance is VISIBLE — THOR's visibility already bounds
            # the distance via the controller's visibilityDistance (1.0m), so no
            # extra geodesic round-trip is needed on the success path.
            success = self._visible_target()
            event = self.controller.last_event
        else:
            before = self.controller.last_event.metadata["agent"]["position"]
            event = self.controller.step(action=name)
            after = event.metadata["agent"]["position"]
            self._episode["path_len"] += float(
                np.hypot(after["x"] - before["x"], after["z"] - before["z"])
            )
        if self._episode["t"] >= self.max_steps:
            done = True

        reward = -0.01 + 10.0 * float(success)
        if self.shaping and not done:
            g = self._geodesic_to_target()
            reward += self.shaping * (self._episode["last_geodesic"] - g)
            self._episode["last_geodesic"] = g

        info: Dict[str, Any] = {}
        if done:
            sp = self._episode["start_geodesic"]
            taken = max(self._episode["path_len"], sp)
            info = {
                "success": float(success),
                "spl": float(success) * sp / taken,
                "episode_len": float(self._episode["t"]),
                "object_type": self._episode["object_type"],
            }
            obs = self.reset()
            return obs, reward, True, info
        return self._obs(event), reward, False, info

    def close(self) -> None:
        try:
            self.controller.stop()
        except Exception:
            pass
