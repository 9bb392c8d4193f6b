"""Multi-process initialisation for data-parallel DD-PPO (port of
`embodied_clip_tpu/parallel/distributed.py`).

The reference's multi-GPU mode is torch.distributed + NCCL, one process per card. Call
`initialize_distributed()` once per process; it reads the same variables as the JAX
package: `ECT_COORDINATOR` (`host:port` or a `tcp://` URL), `ECT_NUM_PROCESSES`,
`ECT_PROCESS_ID`. A single process with no coordinator is a no-op. Nothing tells a
process of a cluster on its own, so an address is always given.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize_distributed"]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda") -> bool:
    """Join the process group from the arguments or the `ECT_*` variables: NCCL when
    `device` is CUDA (rank r on card r mod the card count), gloo on the CPU. Returns
    True if a process group is up (it may hold one process, when a coordinator is
    given). Idempotent."""
    coordinator_address = coordinator_address or os.environ.get("ECT_COORDINATOR")
    if num_processes is None and "ECT_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["ECT_NUM_PROCESSES"])
    if process_id is None and "ECT_PROCESS_ID" in os.environ:
        process_id = int(os.environ["ECT_PROCESS_ID"])

    if coordinator_address is None and num_processes in (None, 1):
        return False  # single process: nothing to do
    if dist.is_initialized():
        return True
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator address, the process "
                         "count and this process's id (ECT_COORDINATOR, "
                         "ECT_NUM_PROCESSES, ECT_PROCESS_ID)")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id)
    return True
