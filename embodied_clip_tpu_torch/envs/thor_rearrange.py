"""iTHOR Rearrangement adapters (1-phase and 2-phase) — HostEnvs over
ai2thor.Controller (port of `embodied_clip_tpu/envs/thor_rearrange.py`).

Behavioral spec from the reference's rearrangement branch (readme_files/
baselines_ithor_rearrangement.md:4-12): the scene starts with some objects moved
and/or opened relative to a goal configuration; the agent must restore it. 1-phase
means the agent observes the CURRENT scene and the GOAL scene simultaneously — the
upstream task runs two THOR instances, an "unshuffle" one the agent acts in and a
"walkthrough" one held at the goal state and rendered from the mirrored agent pose.
This adapter does the same with two controllers.

2-phase (`THORTwoPhaseRearrangeEnv`) is the upstream walkthrough→unshuffle
variant: the agent first explores the scene IN its goal configuration
(navigation only; Done or budget exhaustion ends the phase), then the scene is
shuffled and the agent must restore it from memory — no goal view, a single
controller, and a phase flag in the observation (obs["goal"] ∈ {0, 1}).
The released rearrangement models are 1-phase only
(baselines_ithor_rearrangement.md:7-12); 2-phase covers the branch's other
documented task configuration.

Observations: {"visual": current RGB, "goal_visual": goal-state RGB (same pose),
"goal": 0}. Actions: navigation + PickupMisplaced / PutHeld / OpenTarget /
CloseTarget / Done (the upstream discrete interaction set, with object selection
resolved to the nearest eligible visible instance as the upstream pickup-by-type
actions do). PutHeld targets a receptacle near the held object's goal pose via
PutObject (THOR's PutObject takes the receptacle's objectId) and otherwise
degrades to DropHandObject — the drop-with-snap-adjacent semantics of the
upstream task's DropHeldObjectWithSnap. Metrics per the upstream task: success (everything restored),
prop_fixed (fraction of initially-misplaced objects restored), num_newly_misplaced;
an object counts as "in goal pose" when within pos_threshold meters and its openness
within open_threshold (a distance simplification of upstream's IoU≥0.5 pose match —
same semantics at adapter scope).

Without ai2thor, tests drive this with the scripted controller fixture
(tests/fake_thor.py). The hermetic learning stand-in is
envs/rearrange.GridRearrangeEnv.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from embodied_clip_tpu_torch.envs.base import HostEnv

__all__ = ["THORRearrangeEnv", "THORTwoPhaseRearrangeEnv", "REARRANGE_ACTIONS"]

REARRANGE_ACTIONS = (
    "MoveAhead", "RotateLeft", "RotateRight", "LookUp", "LookDown",
    "PickupMisplaced", "PutHeld", "OpenTarget", "CloseTarget", "Done",
)


class THORRearrangeEnv(HostEnv):
    num_actions = len(REARRANGE_ACTIONS)
    uses_goal_view = True  # 1-phase: second controller renders the goal state

    def __init__(self, scenes: Sequence[str], num_misplaced: int = 2,
                 num_toggled_open: int = 1, width: int = 300, height: int = 300,
                 grid_size: float = 0.25, rotate_degrees: float = 30.0,
                 max_steps: int = 250, visibility_distance: float = 1.5,
                 pos_threshold: float = 0.5, open_threshold: float = 0.2,
                 seed: int = 0, controller_kwargs: Optional[Dict] = None,
                 controller_factory=None):
        if controller_factory is None:
            try:
                from ai2thor.controller import Controller
            except ImportError as e:
                raise ImportError(
                    "ai2thor is required for THORRearrangeEnv; the hermetic "
                    "stand-in is envs.rearrange.GridRearrangeEnv."
                ) from e
            controller_factory = Controller

        kw = dict(gridSize=grid_size, rotateStepDegrees=rotate_degrees,
                  width=width, height=height,
                  visibilityDistance=visibility_distance,
                  **(controller_kwargs or {}))
        self.controller = controller_factory(**kw)          # unshuffle (acted on)
        # walkthrough (goal-state) instance — only the 1-phase task renders a
        # simultaneous goal view; 2-phase relies on the walkthrough PHASE.
        self.goal_controller = (controller_factory(**kw)
                                if self.uses_goal_view else None)
        self.scenes = list(scenes)
        self.num_misplaced = num_misplaced
        self.num_toggled_open = num_toggled_open
        self.grid_size = grid_size
        self.rot_step = rotate_degrees
        self.max_steps = max_steps
        self.pos_threshold = pos_threshold
        self.open_threshold = open_threshold
        self.vis_dist = visibility_distance
        self.rng = random.Random(seed)
        self._episode: Dict[str, Any] = {}

    # --------------------------------------------------------------------- helpers

    def _objects(self, controller=None):
        return (controller or self.controller).last_event.metadata["objects"]

    def _agent(self):
        return self.controller.last_event.metadata["agent"]

    def _mismatch(self, obj) -> Tuple[bool, bool]:
        """(position off, openness off) vs the goal pose."""
        goal = self._episode["goal_poses"].get(obj["objectId"])
        if goal is None:
            return False, False
        d = math.hypot(obj["position"]["x"] - goal["position"]["x"],
                       obj["position"]["z"] - goal["position"]["z"])
        pos_bad = d > self.pos_threshold
        open_bad = abs(float(obj.get("isOpen", False)) - float(goal["isOpen"])) \
            > self.open_threshold
        return pos_bad, open_bad

    def _in_goal_pose(self, obj) -> bool:
        pos_bad, open_bad = self._mismatch(obj)
        return not (pos_bad or open_bad)

    def _misplaced_ids(self) -> set:
        return {o["objectId"] for o in self._objects() if not self._in_goal_pose(o)}

    def _nearest(self, candidates, require_visible=True):
        ag = self._agent()["position"]
        best, best_d = None, np.inf
        for obj in candidates:
            if require_visible and not obj.get("visible", False):
                continue
            d = math.hypot(obj["position"]["x"] - ag["x"],
                           obj["position"]["z"] - ag["z"])
            if d < best_d:
                best, best_d = obj, d
        return best

    def _obs(self) -> Dict[str, np.ndarray]:
        # Mirror the agent pose into the walkthrough instance, render the goal view.
        ag = self._agent()
        self.goal_controller.step(
            action="TeleportFull", position=ag["position"],
            rotation=ag["rotation"], horizon=ag.get("cameraHorizon", 0.0),
            standing=True,
        )
        return {
            "visual": np.asarray(self.controller.last_event.frame, np.uint8),
            "goal_visual": np.asarray(self.goal_controller.last_event.frame, np.uint8),
            "goal": np.int32(0),
        }

    # ------------------------------------------------------------------- lifecycle

    def _record_goal_poses(self, objs) -> Dict[str, Dict]:
        return {
            o["objectId"]: dict(position=dict(o["position"]),
                                isOpen=bool(o.get("isOpen", False)))
            for o in objs
        }

    def _reachable(self):
        return self.controller.step(action="GetReachablePositions") \
            .metadata.get("actionReturn") or []

    def _teleport_random(self, reach) -> None:
        if reach:
            p = self.rng.choice(reach)
            self.controller.step(
                action="TeleportFull", position=p,
                rotation=dict(x=0, y=self.rng.choice([0, 90, 180, 270]), z=0),
                horizon=0, standing=True,
            )

    def _shuffle(self, objs, goal_poses, reach) -> None:
        """The upstream unshuffle-phase scene perturbation: displace pickupable
        objects, toggle openable ones."""
        pickupable = [o for o in objs if o.get("pickupable")]
        self.rng.shuffle(pickupable)
        displaced = {o["objectId"] for o in pickupable[: self.num_misplaced]} \
            if reach else set()
        if displaced:
            # THOR's SetObjectPoses keys entries by the object's `name` metadata
            # field and DISABLES any pickupable OR moveable object missing from
            # the list — so every placeable object gets a pose, moved or not
            # (the upstream unshuffle-phase contract). Omitting moveable-but-
            # not-pickupable objects (chairs etc.) would silently remove them
            # from the scene while the goal view still shows them.
            placeable = [o for o in objs
                         if o.get("pickupable") or o.get("moveable")]
            poses = []
            for o in placeable:
                if o["objectId"] in displaced:
                    p = self.rng.choice(reach)
                    pos = dict(x=p["x"], y=o["position"]["y"], z=p["z"])
                else:
                    pos = dict(o["position"])
                poses.append(dict(objectName=o["name"], position=pos,
                                  rotation=dict(o.get("rotation")
                                                or dict(x=0, y=0, z=0))))
            ev = self.controller.step(action="SetObjectPoses", objectPoses=poses)
            if not ev.metadata["lastActionSuccess"]:
                raise RuntimeError(
                    "SetObjectPoses failed during shuffle: "
                    f"{ev.metadata.get('errorMessage', '')!r}")
        openable = [o for o in self._objects() if o.get("openable")]
        self.rng.shuffle(openable)
        for o in openable[: self.num_toggled_open]:
            want_open = not goal_poses[o["objectId"]]["isOpen"]
            self.controller.step(
                action="OpenObject" if want_open else "CloseObject",
                objectId=o["objectId"], forceAction=True,
            )

    def reset(self) -> Dict[str, np.ndarray]:
        scene = self.rng.choice(self.scenes)
        self.controller.reset(scene=scene)
        self.goal_controller.reset(scene=scene)

        objs = self._objects()
        goal_poses = self._record_goal_poses(objs)
        reach = self._reachable()
        self._shuffle(objs, goal_poses, reach)
        self._teleport_random(reach)  # random agent start

        self._episode = {
            "t": 0,
            "goal_poses": goal_poses,
            "held": None,
        }
        self._episode["start_misplaced"] = self._misplaced_ids()
        self._episode["prev_misplaced"] = set(self._episode["start_misplaced"])
        return self._obs()

    def _finish(self, reward):
        start = self._episode["start_misplaced"]
        now = self._misplaced_ids()
        fixed = start - now
        newly = now - start
        info = {
            "success": float(not now),
            "spl": float(not now),  # upstream reports success; spl kept for schema
            "prop_fixed": float(len(fixed)) / max(len(start), 1),
            "num_newly_misplaced": float(len(newly)),
            "episode_len": float(self._episode["t"]),
            "object_type": "Rearrange",
        }
        reward += 5.0 * info["success"]
        obs = self.reset()
        return obs, reward, True, info

    def step(self, action: int) -> Tuple[Dict[str, np.ndarray], float, bool, Dict[str, Any]]:
        name = REARRANGE_ACTIONS[action]
        self._episode["t"] += 1
        reward = -0.01

        if name == "Done":
            return self._finish(reward)
        if name in ("MoveAhead", "RotateLeft", "RotateRight", "LookUp", "LookDown"):
            self.controller.step(action=name)
        elif name == "PickupMisplaced":
            target = self._nearest(
                [o for o in self._objects()
                 if o.get("pickupable") and self._mismatch(o)[0]]
            )
            if target is not None and self._episode["held"] is None:
                ev = self.controller.step(action="PickupObject",
                                          objectId=target["objectId"])
                if ev.metadata["lastActionSuccess"]:
                    self._episode["held"] = target["objectId"]
        elif name == "PutHeld":
            if self._episode["held"] is not None:
                # THOR's PutObject takes the RECEPTACLE's objectId. Putting the
                # held object anywhere but near its goal pose can't restore it,
                # so only receptacles within pos_threshold of the goal qualify;
                # otherwise drop at the hand pose (one step ahead).
                goal = self._episode["goal_poses"][self._episode["held"]]["position"]
                recep = self._nearest(
                    [o for o in self._objects()
                     if o.get("receptacle")
                     and math.hypot(o["position"]["x"] - goal["x"],
                                    o["position"]["z"] - goal["z"])
                     <= self.pos_threshold]
                )
                ev = None
                if recep is not None:
                    ev = self.controller.step(action="PutObject",
                                              objectId=recep["objectId"])
                if ev is None or not ev.metadata["lastActionSuccess"]:
                    ev = self.controller.step(action="DropHandObject")
                if ev.metadata["lastActionSuccess"]:
                    self._episode["held"] = None
        elif name in ("OpenTarget", "CloseTarget"):
            want_open = name == "OpenTarget"
            target = self._nearest(
                [o for o in self._objects()
                 if o.get("openable") and self._mismatch(o)[1]
                 and bool(o.get("isOpen", False)) != want_open]
            )
            if target is not None:
                self.controller.step(
                    action="OpenObject" if want_open else "CloseObject",
                    objectId=target["objectId"],
                )

        # Shaped reward: +1 per newly fixed object, -1 per newly broken one.
        now = self._misplaced_ids()
        prev = self._episode["prev_misplaced"]
        reward += float(len(prev - now)) - float(len(now - prev))
        self._episode["prev_misplaced"] = now

        if self._episode["t"] >= self.max_steps:
            return self._finish(reward)
        return self._obs(), reward, False, {}

    # ---------------------------------------------------------------------- expert

    def expert_action(self) -> int:
        """Greedy heuristic expert for DAgger labeling (the reference suite trains
        1-phase agents from an expert, baselines_ithor_rearrangement.md:7-12):
        restore held object → else walk to / fix the nearest misplaced object →
        Done when everything matches."""
        mis = self._misplaced_ids()
        if not mis:
            return REARRANGE_ACTIONS.index("Done")
        held = self._episode["held"]
        if held is not None:
            goal = self._episode["goal_poses"][held]["position"]
            nav = self._nav_toward(goal)
            # Put once close AND facing the goal spot (the put lands one grid cell
            # ahead, so it ends up inside pos_threshold of the goal pose).
            if (self._dist_to(goal) <= self.pos_threshold
                    and REARRANGE_ACTIONS[nav] == "MoveAhead"):
                return REARRANGE_ACTIONS.index("PutHeld")
            return nav
        # nearest misplaced object, any visibility; fix position before openness
        objs = [o for o in self._objects() if o["objectId"] in mis]
        target = self._nearest(objs, require_visible=False)
        pos = target["position"]
        if target.get("visible", False):
            pos_bad, open_bad = self._mismatch(target)
            if pos_bad and target.get("pickupable"):
                return REARRANGE_ACTIONS.index("PickupMisplaced")
            if open_bad:
                want_open = self._episode["goal_poses"][target["objectId"]]["isOpen"]
                return REARRANGE_ACTIONS.index(
                    "OpenTarget" if want_open else "CloseTarget")
        return self._nav_toward(pos)

    def _dist_to(self, pos) -> float:
        ag = self._agent()["position"]
        return math.hypot(pos["x"] - ag["x"], pos["z"] - ag["z"])

    def _nav_toward(self, pos) -> int:
        ag = self._agent()
        dx = pos["x"] - ag["position"]["x"]
        dz = pos["z"] - ag["position"]["z"]
        bearing = math.degrees(math.atan2(dx, dz)) % 360  # THOR yaw: 0 = +z
        diff = (bearing - ag["rotation"]["y"]) % 360
        if diff > 180:
            diff -= 360
        if abs(diff) > self.rot_step / 2 + 1e-6:
            return REARRANGE_ACTIONS.index(
                "RotateRight" if diff > 0 else "RotateLeft")
        return REARRANGE_ACTIONS.index("MoveAhead")

    def close(self) -> None:
        for c in (self.controller, self.goal_controller):
            try:
                if c is not None:
                    c.stop()
            except Exception:
                pass


class THORTwoPhaseRearrangeEnv(THORRearrangeEnv):
    """Upstream 2-phase Rearrangement: walkthrough → unshuffle.

    Phase 0 (walkthrough): the scene is in its GOAL configuration; the agent
    may only navigate (interaction actions are inert) and observes the goal
    state directly. `Done` — or exhausting `walkthrough_budget` steps — ends
    the phase: the scene is shuffled, the agent teleports to a fresh start,
    and phase 1 begins. Phase 1 (unshuffle): identical to the 1-phase task
    EXCEPT there is no simultaneous goal view — the agent restores the scene
    from what it memorized during the walkthrough. One controller, not two.

    Observations: {"visual": RGB, "goal": phase ∈ {0, 1}} — the phase flag
    rides the policy's goal-class embedding. Metrics are emitted at the end
    of the unshuffle phase with the 1-phase schema (success/prop_fixed/
    num_newly_misplaced). Ref: baselines_ithor_rearrangement.md:4-12 (the
    released models are 1-phase; 2-phase is the branch's other documented
    task configuration)."""

    uses_goal_view = False
    _NAV = ("MoveAhead", "RotateLeft", "RotateRight", "LookUp", "LookDown")

    def __init__(self, *args, walkthrough_budget: int = 50, **kw):
        super().__init__(*args, **kw)
        self.walkthrough_budget = walkthrough_budget

    def _obs(self) -> Dict[str, np.ndarray]:
        return {
            "visual": np.asarray(self.controller.last_event.frame, np.uint8),
            "goal": np.int32(self._episode.get("phase", 0)),
        }

    def reset(self) -> Dict[str, np.ndarray]:
        scene = self.rng.choice(self.scenes)
        self.controller.reset(scene=scene)
        objs = self._objects()
        # Walkthrough phase: the scene STAYS in its goal configuration; the
        # shuffle is deferred to the phase switch.
        self._episode = {
            "t": 0,
            "walk_t": 0,
            "phase": 0,
            "goal_poses": self._record_goal_poses(objs),
            "held": None,
        }
        self._reach = self._reachable()
        self._teleport_random(self._reach)
        return self._obs()

    def _begin_unshuffle(self) -> None:
        self._shuffle(self._objects(), self._episode["goal_poses"], self._reach)
        self._teleport_random(self._reach)
        self._episode["phase"] = 1
        self._episode["start_misplaced"] = self._misplaced_ids()
        self._episode["prev_misplaced"] = set(self._episode["start_misplaced"])

    def step(self, action: int):
        if self._episode["phase"] == 0:
            name = REARRANGE_ACTIONS[action]
            self._episode["walk_t"] += 1
            if name in self._NAV:
                self.controller.step(action=name)
            # interactions are inert during the walkthrough; Done ends it
            if name == "Done" \
                    or self._episode["walk_t"] >= self.walkthrough_budget:
                self._begin_unshuffle()
            return self._obs(), 0.0, False, {}
        return super().step(action)

    def expert_action(self) -> int:
        # Walkthrough demo: survey the goal configuration with one full
        # revolution from the start pose, then Done. The demonstrated
        # behavior must gather the information the unshuffle labels rely on
        # (the phase-1 expert reads scene metadata the policy can only get
        # from walkthrough memory); upstream's walkthrough agent is likewise
        # an explorer, not a no-op.
        if self._episode["phase"] == 0:
            scan = int(round(360.0 / self.rot_step))
            if self._episode["walk_t"] < min(scan, self.walkthrough_budget - 1):
                return REARRANGE_ACTIONS.index("RotateRight")
            return REARRANGE_ACTIONS.index("Done")
        return super().expert_action()
