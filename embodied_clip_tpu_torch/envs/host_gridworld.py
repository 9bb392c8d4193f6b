"""Pure-numpy single-instance grid-nav HostEnv (port of
`embodied_clip_tpu/envs/host_gridworld.py`).

The host-side reference implementation of the HostEnv contract (envs/base.py): same
task family as the batched envs/gridworld.py but run like an external simulator —
one instance per worker process, uint8 frame observations — so VectorEnv and the
host rollout path are testable without AI2-THOR/habitat-sim binaries.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from embodied_clip_tpu_torch.envs.base import HostEnv

__all__ = ["HostGridNav"]

_DIRS = np.array([[-1, 0], [0, 1], [1, 0], [0, -1]])


class HostGridNav(HostEnv):
    # THOR's 6-action ObjectNav space, same indices as envs/thor.py and the
    # batched envs/gridworld.py, so checkpoints transfer across backends.
    num_actions = 6  # MoveAhead, RotateLeft, RotateRight, LookUp, LookDown, End

    def __init__(self, size: int = 6, num_classes: int = 12, max_steps: int = 48,
                 frame_px: int = 8, seed: int = 0):
        self.size = size
        self.num_classes = num_classes
        self.max_steps = max_steps
        self.frame_px = frame_px
        self.rng = np.random.RandomState(seed)
        self._new_episode()

    def _new_episode(self):
        self.pos = self.rng.randint(0, self.size, 2)
        self.dir = self.rng.randint(0, 4)
        self.hor = 0  # camera horizon in {-1(up), 0, 1(down)}
        self.objects = self.rng.randint(0, self.size, (2, 2))
        c0 = self.rng.randint(0, self.num_classes)
        self.classes = np.array([c0, (c0 + 1 + self.rng.randint(self.num_classes - 1))
                                 % self.num_classes])
        self.target = self.rng.randint(0, 2)
        self.t = 0
        self.start_dist = max(1, int(np.abs(self.pos - self.objects[self.target]).sum()))

    def _frame(self) -> np.ndarray:
        """Egocentric 7×7 cell view rendered to a uint8 RGB frame."""
        v = 7
        px = self.frame_px
        img = np.zeros((v * px, v * px, 3), np.uint8)
        rot = {0: lambda f, r: (-f, r), 1: lambda f, r: (r, f),
               2: lambda f, r: (f, -r), 3: lambda f, r: (-r, -f)}[self.dir]
        for i in range(v):
            for j in range(v):
                # camera pitch shifts the window along the forward axis
                f, r = (v - 1 - i) - v // 2 - self.hor, j - v // 2
                dy, dx = rot(f, r)
                y, x = self.pos[0] + dy, self.pos[1] + dx
                if not (0 <= y < self.size and 0 <= x < self.size):
                    continue
                cell = img[i * px:(i + 1) * px, j * px:(j + 1) * px]
                cell[:, :, 1] = 60  # in-bounds
                for k in range(2):
                    if (self.objects[k] == (y, x)).all():
                        cell[:, :, 0] = int(40 + 215 * self.classes[k] / self.num_classes)
                        cell[:, :, 2] = 255
        return img

    def _obs(self) -> Dict[str, np.ndarray]:
        return {"visual": self._frame(),
                "goal": np.int32(self.classes[self.target])}

    def reset(self) -> Dict[str, np.ndarray]:
        self._new_episode()
        return self._obs()

    def step(self, action: int) -> Tuple[Dict[str, np.ndarray], float, bool, Dict[str, Any]]:
        d_prev = np.abs(self.pos - self.objects[self.target]).sum()
        if action == 0:
            self.pos = np.clip(self.pos + _DIRS[self.dir], 0, self.size - 1)
        elif action == 1:
            self.dir = (self.dir - 1) % 4
        elif action == 2:
            self.dir = (self.dir + 1) % 4
        elif action == 3:
            self.hor = max(self.hor - 1, -1)
        elif action == 4:
            self.hor = min(self.hor + 1, 1)
        self.t += 1
        d_new = np.abs(self.pos - self.objects[self.target]).sum()
        success = action == 5 and d_new <= 1
        done = action == 5 or self.t >= self.max_steps
        reward = -0.01 + 0.2 * float(d_prev - d_new) + 10.0 * float(success)
        info: Dict[str, Any] = {}
        if done:
            info = {
                "success": float(success),
                "spl": float(success) * self.start_dist / max(self.t, self.start_dist),
                "episode_len": float(self.t),
            }
            self._new_episode()
        return self._obs(), reward, bool(done), info
