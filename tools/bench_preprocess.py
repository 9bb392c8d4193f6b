#!/usr/bin/env python3
"""Time kernel K1 (`embodied_clip_tpu_torch/csrc/preprocess.cu`) on one NVIDIA GPU at the
main path's shape, (n, 300, 300, 3) uint8 → (n, 224, 224, 3), for n = 1, 8, 32 and 128
(the batches `chip_smoke.py` serves), in bf16 and f32, beside the kernel's bound.

    python3 tools/bench_preprocess.py [--source a.cu,b.cu] [--diagnostics]

Frames are `golden_frames(128)` (seed 0) on the device. `--source` builds other versions
of `preprocess.cu` with the repository's nvcc flags and times them in the same run, in
turns (each source in order, then in reverse), keeping each one's least time. A source
with the row-tile interface of commit 88a0410 is driven with its own tables; write that
file out first where git is at hand (the copy that runs on the card needs it as a file),

    git show 88a0410:embodied_clip_tpu_torch/csrc/preprocess.cu > build/preprocess_88a0410.cu

`--diagnostics` adds three builds of the repository's source that each skip most of one
phase's work, to show what that phase costs (their output is wrong and not checked):
`no convert` (the staged bytes are not converted), `one width tap` (the width pass
reads one pixel of its window, not T + D) and `one height tap` (the height pass reads
one ring row, not T).

Each version's output is held to the plain version: bit-equal at batch 128 (f32 and
bf16), and the ≤1.5 LSB, <1e-3 flipped contract at every batch. The bound is the larger
of the bytes (each input byte read once, each output written once) over the card's
memory rate and the multiply-adds over its f32 rate (`chip_smoke.preprocess_work`).
Prints one JSON line and writes it to chiprun_out/bench_preprocess.json. Exits non-zero
without a CUDA device, or when a version disagrees with the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BATCHES = (1, 8, 32, 128)
# Diagnostic builds of csrc/preprocess.cu: the line each one replaces, and with what.
DIAGNOSTICS = {
    "no convert": ("    for (int P = tid; P < (i1 - i0) * W; P += kThreads) {",
                   "    for (int P = tid; P < 0; P += kThreads) {"),
    "one width tap": ("        for (int j = 0; j < T + D; ++j) {",
                      "        for (int j = 0; j < 1; ++j) {"),
    "one height tap": ("        for (int t = 0; t < T; ++t) {\n          const float4* ar",
                       "        for (int t = 0; t < 1; ++t) {\n          const float4* ar"),
}


def _row_tile_args(frames, size, method):
    """Tables and sizes of the row-tile kernel of commit 88a0410 (one block per image
    and tile of up to 16 output rows; unpadded taps)."""
    import numpy as np
    import torch

    from embodied_clip_tpu_torch.ops.resize import resize_plan

    n, h, w, _ = frames.shape
    wh, ww = resize_plan((h, w), size, (size, size), method)

    def taps(m):
        nz = [np.flatnonzero(r) for r in m]
        first = np.array([z[0] if z.size else 0 for z in nz])
        t = max(int(z[-1] - z[0]) + 1 for z in nz if z.size)
        start = np.minimum(first, m.shape[1] - t)
        return start.astype(np.int32), np.stack(
            [m[o, s:s + t] for o, s in enumerate(start)]).astype(np.float32)

    w_start, w_taps = taps(ww)
    h_start, h_taps = taps(wh)
    th, rows = h_taps.shape[1], 16
    while True:
        in0 = [int(h_start[r:r + rows].min()) for r in range(0, size, rows)]
        span = [int(h_start[r:r + rows].max()) + th - i for r, i in zip(range(0, size, rows), in0)]
        if max(span) * (w + size) * 3 <= 232_448 or rows == 1:
            break
        rows //= 2
    tabs = [torch.as_tensor(a).cuda() for a in
            (w_start, w_taps, h_start, h_taps, np.asarray(in0, np.int32),
             np.asarray(span, np.int32))]
    vec4 = (w * 3) % 4 == 0 and frames.data_ptr() % 4 == 0
    ints = (n, h, w, size, w_taps.shape[1], th, rows, len(in0), max(span), int(vec4))
    return tabs, ints


def _runner(lib, row_tile: bool):
    """fn(frames, out, dtype) that launches `lib`'s kernel on frames → out."""
    import torch

    from embodied_clip_tpu_torch import constants
    from embodied_clip_tpu_torch.ops.kernels import preprocess_kernel as K

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ect_fused_preprocess.argtypes = (([p] * 8 + [i] * 11) if row_tile else
                                         ([p] * 10 + [i] * 16)) + [f] * 6 + [i, p]
    inv, shift = K._norm_consts(constants.CLIP_MEAN, constants.CLIP_STD)
    consts = [float(v) for v in inv] + [float(v) for v in shift]
    cache = {}

    def run(frames, out, dtype):
        n, h, w, _ = frames.shape
        bf16 = int(dtype == torch.bfloat16)
        stream = torch.cuda.current_stream().cuda_stream
        if row_tile:
            key = (n, frames.data_ptr())
            if key not in cache:
                cache[key] = _row_tile_args(frames, 224, "bicubic")
            tabs, ints = cache[key]
            err = lib.ect_fused_preprocess(frames.data_ptr(), out.data_ptr(),
                                           *(t.data_ptr() for t in tabs), *ints, bf16,
                                           *consts, 0, stream)
        else:
            plan, tabs = K._device_tables((h, w), 224, "bicubic", frames.device)
            chunks, rows, grid = K.work_items(plan, n, K._sm_count(frames.device))
            err = lib.ect_fused_preprocess(
                frames.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in tabs), n, h, w,
                224, plan.taps, plan.pair_gap, plan.rows_par, plan.xf_stride,
                plan.band_rows, plan.ring_rows, chunks, rows, grid, plan.stage_bytes,
                plan.smem_bytes, bf16, *consts, 0, stream)
        if err:
            raise RuntimeError(f"preprocess launch failed: {err}")

    return run


def cuda_ms(fn, iters=200, warmup=5):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_preprocess: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke
    from embodied_clip_tpu_torch import constants
    from embodied_clip_tpu_torch.ops.kernels import _build
    from embodied_clip_tpu_torch.ops.kernels import preprocess_kernel as K
    from embodied_clip_tpu_torch.parity import golden_frames

    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default="", help="comma-separated .cu files to compare")
    ap.add_argument("--diagnostics", action="store_true",
                    help="also time builds that skip most of one phase's work")
    opts = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = chip_smoke.card_rates(torch.cuda.get_device_name(0))
    sources = opts.source.split(",") if opts.source else [str(_build.CSRC / "preprocess.cu")]
    diagnostic = set()
    if opts.diagnostics:
        src = (_build.CSRC / "preprocess.cu").read_text()
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        for name, (old, new) in DIAGNOSTICS.items():
            if old not in src:
                raise RuntimeError(f"preprocess.cu: the line the '{name}' build replaces "
                                   "has changed")
            path = str(_build.BUILD_DIR / f"preprocess_{name.replace(' ', '_')}.cu")
            with open(path, "w") as f:
                f.write(src.replace(old, new))
            sources.append(path)
            diagnostic.add(path)
    runs, ptxas = {}, {}
    for path in sources:
        lib_path, log = _build.build_variant(path, "preprocess")
        ptxas[path] = [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
        runs[path] = _runner(ctypes.CDLL(lib_path), "tile_in0" in open(path).read())

    mean, std = constants.CLIP_MEAN, constants.CLIP_STD
    lsb = 1.0 / 255.0 / min(std)
    frames = torch.from_numpy(golden_frames(128)).cuda()
    ok, checks = True, {}
    for path, run in runs.items():
        for n in BATCHES:
            for dtype in (torch.float32, torch.bfloat16):
                x = frames[:n]
                out = torch.empty((n, 224, 224, 3), dtype=dtype, device="cuda")
                run(x, out, dtype)
                ref = K.fused_preprocess_reference(x, 224, mean, std, dtype=dtype)
                err = (out.float() - ref.float()).abs()
                worst, flipped = float(err.max()) / lsb, float((err > 0.5 * lsb).float().mean())
                good = worst <= 1.5 and flipped < 1e-3 and (n != 128 or torch.equal(out, ref))
                checks.setdefault(path, {})[f"{n} {str(dtype)[6:]}"] = {
                    "max_lsb": worst, "flipped": flipped, "bit_equal": bool(torch.equal(out, ref))}
                ok &= good or path in diagnostic
    times = {}
    order = list(runs) + list(reversed(runs))
    for n in BATCHES:
        for dtype in (torch.bfloat16, torch.float32):
            x = frames[:n]
            out = torch.empty((n, 224, 224, 3), dtype=dtype, device="cuda")
            key = f"{n} {str(dtype)[6:]}"
            for path in order:
                t = cuda_ms(lambda: runs[path](x, out, dtype))
                times.setdefault(path, {}).setdefault(key, []).append(t)
    bounds = {}
    for n in BATCHES:
        for dtype, size in ((torch.bfloat16, 2), (torch.float32, 4)):
            nbytes, flops = chip_smoke.preprocess_work(n, (300, 300), 224, size)
            bytes_ms, ops_ms = nbytes / card[1] * 1e3, flops / card[2] * 1e3
            bounds[f"{n} {str(dtype)[6:]}"] = {
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    result = {"card": smi, "rates": list(card), "bounds": bounds, "ptxas": ptxas,
              "checks": checks, "diagnostic": sorted(diagnostic), "runs_ms": times,
              "ms": {p: {k: min(v) for k, v in t.items()} for p, t in times.items()}}
    for path, best in result["ms"].items():
        for key, ms in best.items():
            b = bounds[key]["bound_ms"]
            print(f"{os.path.basename(path)} batch {key}: {ms:.4f} ms, bound {b:.4f} ms "
                  f"({b / ms:.1%}); {smi}")
    print(json.dumps(result))
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/bench_preprocess.json", "w") as f:
        json.dump(result, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
