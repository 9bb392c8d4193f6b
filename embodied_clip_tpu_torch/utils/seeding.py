"""Global seeding with the reference's determinism contract (port of
`embodied_clip_tpu/utils/seeding.py`).

The reference calls `pl.seed_everything(1)` (train.py:117): seed python `random`, numpy
and the framework RNG. Where the JAX package returns a root `jax.random.PRNGKey`, this
returns a `torch.Generator` on the requested device, seeded with the same seed, to be
threaded through the program (envs, action samples).
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

from embodied_clip_tpu_torch.models.clip import _device

__all__ = ["seed_everything"]


def seed_everything(seed: int = 1, device="cuda") -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=_device(device)).manual_seed(seed)
