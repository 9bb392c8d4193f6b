"""Data-parallel helpers for DD-PPO (the port's counterpart of
`embodied_clip_tpu/parallel/mesh.py`; it builds no mesh).

In the JAX package one SPMD step shards the env batch over the mesh's `dp` axis and XLA
inserts the gradient all-reduce. Here each process owns a contiguous slice of the env
batch (`shard_batch`), starts from rank 0's weights (`replicate`), and the learner sums
gradients and batch statistics over processes (`all_sum`, `all_sum_`). Outside a
process group every helper is the identity.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist

__all__ = ["rank", "world_size", "split_sizes", "shard_batch", "replicate", "all_sum", "all_sum_",
           "host_scalar"]


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if _active() else 0


def world_size() -> int:
    return dist.get_world_size() if _active() else 1


def split_sizes(n: int, parts: int):
    """`parts` contiguous sizes summing to n, the remainder spread over the first."""
    size, rem = divmod(n, parts)
    return [size + (1 if i < rem else 0) for i in range(parts)]


def shard_batch(batch: int) -> slice:
    """This process's contiguous slice of a global batch of `batch` envs."""
    sizes = split_sizes(batch, world_size())
    start = sum(sizes[:rank()])
    return slice(start, start + sizes[rank()])


@torch.no_grad()
def replicate(tensors: Iterable[torch.Tensor]) -> None:
    """Overwrite every process's tensors with rank 0's, in place."""
    if _active():
        for t in tensors:
            dist.broadcast(t, 0)


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over processes (a new tensor in a process group, `t` itself
    otherwise). Runs the collective whenever a group is up, even of one process."""
    if not _active():
        return t
    t = t.clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


@torch.no_grad()
def all_sum_(tensors: Iterable[torch.Tensor]) -> None:
    """Sum tensors over processes in place, as one flat buffer (one collective)."""
    tensors = list(tensors)
    if not _active() or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def host_scalar(v) -> float:
    """float() of a scalar metric (a 0-dim tensor on any device, or a number)."""
    return float(v.item()) if isinstance(v, torch.Tensor) else float(v)
