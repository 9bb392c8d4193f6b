"""What both sides are handed, made from the seed: the reference module holding the
configuration's weights (its state dict is what the program loads), and the streams
of the seed that each kind of input draws from."""

from __future__ import annotations

import torch

from benchmark.harness.cell import module
from benchmark.harness.weights import fill_, seeded_generator

WEIGHTS, CALIBRATION, FRAMES, POLICY, ENV, SAMPLES = range(1, 7)   # streams of the seed


def reference_module(config: dict, seed: int, device) -> torch.nn.Module:
    """The configuration's float32 reference, holding weights made from the seed."""
    with torch.device("meta"):
        ref = module("reference", config["reference"]).build(config)
    ref = ref.to_empty(device=device)
    fill_(ref, seeded_generator(seed, WEIGHTS, device))
    return ref.eval().requires_grad_(False)


class tf32_off:
    """Full float32 products inside (the reference's own setting), restored after."""

    def __enter__(self):
        self.flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.flags
