"""Closed-loop encoding: `FrozenEncoder.encode` on uint8 frame batches.

The traffic file sets the batch, the frame size and layout, the pool of distinct
seeded batches cycled through, where they live (`device`: resident on the card;
`host`: numpy arrays, as a host pool's frame ring hands them over), and whether each
request is synchronised (`sync_each`, which gives per-request latency). A unit is one
`encode` call. The output of each pool entry's last call in the window is kept, and
after the window every kept feature of every key is compared, frame by frame, with the
float32 reference on the same frames.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness.cell import module
from benchmark.harness.compare import cosine_distances
from benchmark.harness.frames import golden_frames
from benchmark.harness.inputs import CALIBRATION, FRAMES, reference_module, tf32_off
from benchmark.harness.program import build_encoder, program_section
from benchmark.harness.runner import log
from benchmark.harness.weights import seeded_generator
from benchmark.reference.preprocess import preprocess

KIND = "encode"
REFERENCE_BLOCK = 128   # frames per reference call


def max_distances(ref: torch.nn.Module, config: dict, frames: torch.Tensor, outs: dict,
                  keys=None, block: int = REFERENCE_BLOCK) -> dict:
    """{"cos.<key>": the largest per-frame cosine distance of `outs` (feature batches
    of `frames`, by key) from the reference}, for the reference's `keys` (all of them
    by default), computed in blocks of frames with TF32 off. A key the program did not
    produce for every frame, or a distance that is not finite, reads infinite."""
    worst = {}
    with torch.no_grad(), tf32_off():
        for lo in range(0, frames.shape[0], block):
            hi = min(lo + block, frames.shape[0])
            x = preprocess(frames[lo:hi], config["model"]["image_size"], config["family"])
            for k, r in ref.features(x).items():
                if keys is not None and k not in keys:
                    continue
                got = outs.get(k)
                if got is None or got.shape[0] != frames.shape[0] or \
                        got[lo:hi].numel() != r.numel():
                    worst[k] = float("inf")
                    continue
                d = cosine_distances(got[lo:hi], r)
                d = float(d.max()) if bool(torch.isfinite(d).all()) else float("inf")
                worst[k] = max(worst.get(k, 0.0), d)
    return {f"cos.{k}": v for k, v in worst.items()}


class Driver:
    def __init__(self, cell, seed: int, device, control: bool = False, group=None):
        # `group` (`harness/ranks.py`) is unused: an encode cell runs on one card.
        self.cell, self.seed, self.device, self.control = cell, seed, torch.device(device), control
        t = cell.traffic
        self.batch, self.pool_size = t["batch"], t["pool"]
        self.hw = tuple(t["frame_hw"])
        self.min_units = self.pool_size   # every pool entry is encoded in the window

    def setup(self):
        cfg, t, dev = self.cell.config, self.cell.traffic, self.device
        t0 = time.time()
        self.ref = reference_module(cfg, self.seed, dev)
        calib = golden_frames(cfg["calibration_frames"], *cfg["calibration_hw"],
                              seeded_generator(self.seed, CALIBRATION, dev))
        t1 = time.time()
        self.enc = build_encoder(program_section(cfg, self.control), self.ref.state_dict(),
                                 calib, dev)
        t2 = time.time()
        frames = golden_frames(self.pool_size * self.batch, *self.hw,
                               seeded_generator(self.seed, FRAMES, dev))
        self.frames = frames.view(self.pool_size, self.batch, *self.hw, 3)
        h, w = self.hw
        shape = (self.batch, h, w * 3) if t["layout"] == "flat" else (self.batch, h, w, 3)
        if t["resident"] == "host":
            self.inputs = [np.ascontiguousarray(f.cpu().numpy()).reshape(shape)
                           for f in self.frames]
        else:
            self.inputs = [f.view(shape) for f in self.frames]
        self.sync_each = t["sync_each"]
        self.kept = [None] * self.pool_size
        log(f"[bench] the cell's set-up: weights and calibration frames {t1 - t0:.3f} s (the "
            f"first CUDA call included), the program built {t2 - t1:.3f}, inputs "
            f"{time.time() - t2:.3f}")

    def unit(self, i: int):
        j = i % self.pool_size
        out = self.enc.encode(self.inputs[j])
        if self.sync_each and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.kept[j] = out

    def start_window(self):
        self.kept = [None] * self.pool_size   # only the window's outputs are judged

    def window_metrics(self, units: int, elapsed: float, unit_times) -> dict:
        m = {"encode_fps": units * self.batch / elapsed}
        if self.sync_each:
            m["request_p95_ms"] = float(np.percentile(np.asarray(unit_times), 95)) * 1e3
        return m

    def unit_work(self) -> dict:
        cfg = self.cell.config
        return module("work", cfg["work"]).work(cfg, self.batch, self.hw)

    def release(self):
        del self.enc
        self.inputs = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self) -> dict:
        """{"cos.<key>": the largest per-frame cosine distance of the kept outputs from
        the reference}; a pool entry the window never produced reads infinite."""
        if any(k is None for k in self.kept):
            return {}
        outs = {k: torch.cat([o[k] for o in self.kept]) for k in self.kept[0]}
        return max_distances(self.ref, self.cell.config, self.frames.reshape(-1, *self.hw, 3),
                             outs)
