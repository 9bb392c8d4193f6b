#!/usr/bin/env python3
"""Split a batch-128 int8 path-A encode of `clip_rn50` into its pieces, on one NVIDIA GPU.

    python3 tools/profile_int8_split.py [--profile]

The encoder is `clip_rn50`, random weights from seed 0, BN-folded and quantized on
golden_frames(32) (`bench.py`'s recipe); the frames are golden_frames(128). CUDA events
are recorded on the stream at the entry and exit of each kernel wrapper the encode calls
(K1 `fused_preprocess`, the stem `_stem` with K2 inside it, K3 `fused_stage1_int8`, each
K5 `fused_resblocks_int8`, each stride block: `fused_stride_block_int8`, or its plain
version `fused_stride_block_int8_reference` with `kernel_stride_blocks=False`), so the
stream time between two events is the piece between them: the stem's f32 convs and
passes (the stem minus K2), each stride block, the head after the last K5 run. Path A is
timed with `kernel_stride_blocks` on (the default) and off, in turns (a, b, b, a) over 10
encodes. With `--profile`, torch.profiler's device time by op of 3 encodes of each is
printed.

Writes chiprun_out/profile_int8_split.json. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Spans:
    """Records a CUDA event before and after every call of the wrapped functions; the
    labelled event list is the encode's timeline on the stream."""

    def __init__(self):
        self.events, self.patched = [], []

    def mark(self, label):
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((label, ev))

    def wrap(self, module, name, label):
        fn = getattr(module, name)

        def wrapped(*args, **kw):
            self.mark(f"{label} start")
            out = fn(*args, **kw)
            self.mark(f"{label} end")
            return out

        wrapped.launches = getattr(fn, "launches", 0)
        setattr(module, name, wrapped)
        self.patched.append((module, name, fn))

    def restore(self):
        for module, name, fn in reversed(self.patched):
            setattr(module, name, fn)
        self.patched = []


def segments(events):
    """[(piece, ms)] between consecutive events: inside a wrapper its label, between two
    wrappers the glue after the first ("after X")."""
    out, depth = [], []
    for (a, ea), (_, eb) in zip(events, events[1:]):
        label, edge = a.rsplit(" ", 1)
        if label != "encode":
            if edge == "start":
                depth.append(label)
            else:
                depth.pop()
        piece = depth[-1] if depth else f"after {label}"
        if a == "encode start":
            piece = "frames to the device"
        if edge == "end" and depth:
            piece = f"{depth[-1]} (after {label})"
        out.append((piece, ea.elapsed_time(eb)))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_int8_split: no CUDA device is available", file=sys.stderr)
        return 1
    from embodied_clip_tpu_torch.models.encoders import build_encoder
    from embodied_clip_tpu_torch.ops import quantize as Q
    from embodied_clip_tpu_torch.ops.kernels import _build
    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
    from embodied_clip_tpu_torch.ops.kernels import preprocess_kernel as K
    from embodied_clip_tpu_torch.ops.kernels import stem_kernel as SK
    from embodied_clip_tpu_torch.parity import golden_frames

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    _build.build(_build.SOURCES)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    enc = build_encoder("clip_rn50", dtype=torch.bfloat16, device="cuda").fold_bn()
    qenc = enc.quantize(golden_frames(32))
    x = torch.from_numpy(golden_frames(128)).cuda()
    variants = {"path A": qenc,
                "path A, kernel_stride_blocks=False": qenc.with_kernels(kernel_stride_blocks=False)}

    spans = Spans()
    spans.wrap(K, "fused_preprocess", "K1")
    spans.wrap(Q, "_stem", "stem")
    spans.wrap(SK, "stem3_requant_pool_int8", "K2")
    spans.wrap(BK, "fused_stage1_int8", "K3")
    spans.wrap(BK, "fused_resblocks_int8", "K5")
    spans.wrap(BK, "fused_stride_block_int8", "stride block")
    spans.wrap(BK, "fused_stride_block_int8_reference", "stride block, plain")

    def split(e):
        """The timeline of one encode: [(piece, ms)], and the encode's ms."""
        spans.events = []
        spans.mark("encode start")
        e.encode(x)
        spans.mark("encode end")
        torch.cuda.synchronize()
        return segments(spans.events)

    results = {}
    try:
        for label, e in variants.items():
            for _ in range(2):
                split(e)  # warm-up
        for label in list(variants) + list(reversed(variants)):
            runs = [split(variants[label]) for _ in range(10)]
            r = results.setdefault(label, {"runs": []})
            r["runs"].append([sum(ms for _, ms in run) for run in runs])
            # The median encode's pieces, numbered by their order in the encode.
            mid = sorted(runs, key=lambda run: sum(ms for _, ms in run))[len(runs) // 2]
            r["pieces"] = [[f"{i:02d} {piece}", ms] for i, (piece, ms) in enumerate(mid)]
    finally:
        spans.restore()
    for label, r in results.items():
        encode = [min(v) for v in r["runs"]]
        print(f"{label}: batch-128 encode {', '.join(f'{m:.3f}' for m in encode)} ms "
              f"(least of 10, each turn); {smi}")
        for piece, ms in r["pieces"]:
            print(f"  {piece:60s} {ms:8.4f} ms")
    if "--profile" in sys.argv[1:]:
        from torch.profiler import ProfilerActivity, profile

        for label, e in variants.items():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    e.encode(x)
                torch.cuda.synchronize()
            print(f"{label}, 3 encodes of golden_frames(128), device time by op:")
            print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30))
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/profile_int8_split.json", "w") as f:
        json.dump({"card": smi, "variants": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
