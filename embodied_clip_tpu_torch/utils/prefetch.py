"""Host→device prefetch: keep the next batches' copies in flight while the card
computes the current step (port of `embodied_clip_tpu/utils/prefetch.py`; the analogue
of the reference's DataLoader worker pools, data.py:70-86: transfer/compute overlap
instead of host-side parallelism).

On a CUDA device each numpy array goes into a pinned host tensor and then
`.to(device, non_blocking=True)`, so the copy runs on the stream while the host moves
on; on the CPU it is a plain copy into a tensor.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

__all__ = ["prefetch_to_device", "to_device"]


def to_device(item: Any, device) -> Any:
    """`item` (numpy arrays or tensors, nested in tuples, lists and dicts) on `device`."""
    if isinstance(item, (tuple, list)):
        return type(item)(to_device(v, device) for v in item)
    if isinstance(item, dict):
        return {k: to_device(v, device) for k, v in item.items()}
    t = torch.from_numpy(np.ascontiguousarray(item)) if isinstance(item, np.ndarray) else item
    device = torch.device(device)
    if device.type == "cuda":
        if t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=True)
    return t.to(device, copy=True)


def prefetch_to_device(iterator: Iterable, size: int = 2,
                       put: Optional[Callable[[Any], Any]] = None,
                       device="cuda") -> Iterator:
    """Yield the items of `iterator` with up to `size` of them already sent to the
    device: `put(item)` if given, else `to_device(item, device)`."""
    queue = collections.deque()
    put = put or (lambda item: to_device(item, device))

    it = iter(iterator)
    try:
        for _ in range(size):
            queue.append(put(next(it)))
    except StopIteration:
        pass
    while queue:
        out = queue.popleft()
        try:
            queue.append(put(next(it)))
        except StopIteration:
            pass
        yield out
