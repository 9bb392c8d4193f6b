"""Data-parallel DD-PPO over torch.distributed (NCCL on cards, gloo on the CPU)."""

from embodied_clip_tpu_torch.parallel.distributed import initialize_distributed

__all__ = ["initialize_distributed"]
