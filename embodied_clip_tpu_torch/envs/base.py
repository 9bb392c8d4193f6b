"""Host-env API: the contract between external CPU simulators and the device loop
(port of `embodied_clip_tpu/envs/base.py`).

The reference's simulators are external native processes (AI2-THOR Unity via
ai2thor.Controller, thor_frames.py:25-36; habitat-sim C++, baselines_habitat.md:20-27)
driven per-process by allenact/habitat vectorized samplers. Here a `HostEnv` is any
object with numpy-batched `reset`/`step`; `VectorEnv` (envs/vector.py) fans a batch of
single-instance envs across worker processes and presents the same interface.

Observations are dicts of numpy arrays; 'visual' is uint8 (H, W, 3) frames — encoding
happens on the card (the frozen encoder), never on the host.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Tuple

import numpy as np

__all__ = ["HostEnv"]

Obs = Dict[str, np.ndarray]


class HostEnv(abc.ABC):
    """Single-instance env run on the host (one simulator process)."""

    num_actions: int

    @abc.abstractmethod
    def reset(self) -> Obs:
        ...

    @abc.abstractmethod
    def step(self, action: int) -> Tuple[Obs, float, bool, Dict[str, Any]]:
        """Returns (obs, reward, done, info). On done, obs must already be the first
        observation of the next episode (auto-reset), and info carries the finished
        episode's 'success', 'spl', 'episode_len'."""
        ...

    def close(self) -> None:
        pass
