"""Envs of the port: the batched on-device GridNav and rearrangement envs, and the host
envs (single-instance simulators behind `HostEnv`, pooled by `VectorEnv`)."""

from embodied_clip_tpu_torch.envs.gridworld import ACTIONS, GridNavEnv, GridNavState

__all__ = ["ACTIONS", "GridNavEnv", "GridNavState"]
