from embodied_clip_tpu_torch.envs.gridworld import ACTIONS, GridNavEnv, GridNavState

__all__ = ["ACTIONS", "GridNavEnv", "GridNavState"]
