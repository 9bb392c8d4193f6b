#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`embodied_clip_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # build the kernels, check them, drive the port
    python3 chip_smoke.py --profile  # also print a torch.profiler breakdown of an encode

Phases:
  1. torch version, device, and `nvidia-smi`'s name and power limit;
  2. build every CUDA source of the port with nvcc (in parallel) and time it;
  3. hold kernel K1 (fused preprocess) to its plain PyTorch version on the card, at the
     main path's shape (golden_frames(128), 300x300 → 224): ≤1.5 uint8 LSB with <1e-3
     of pixels flipped, bf16 output bit-equal to the f32 output cast; time both and
     compute the kernel's bound for this card;
  4. drive the main path: bf16, BN-folded `clip_rn50` serving four requests of fresh
     uint8 frames (batch 1, 8, 32, 128, NHWC and flat); check keys, shapes, finite
     values and that K1 launched once per request; hold the bf16 features to the
     port's unfolded f32 encoder (TF32 off) at ≤1e-3 cosine; time a batch-128 encode;
  5. print {"kernels": [...]}, then the last line {"ok": true, "device": {...}}.

Any failed check raises, and the script exits non-zero. It exits non-zero at once, and
prints no result, where no CUDA device is available.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# Card → (device-memory bytes/s, f32 CUDA-core FLOP/s), NVIDIA data sheets, dense.
# Matched by substring of the device name, most specific first.
CARDS = (("H100 PCIe", 2.0e12, 51e12), ("H100 NVL", 3.9e12, 60e12),
         ("H100", 3.35e12, 67e12), ("H200", 4.8e12, 67e12))
REQUESTS = ((1, "nhwc"), (8, "flat"), (32, "nhwc"), (128, "flat"))
LSB_LIMIT, FLIP_LIMIT, COSINE_LIMIT = 1.5, 1e-3, 1e-3


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def card_rates(name: str):
    for key, bw, flops in CARDS:
        if key in name:
            return bw, flops, key
    print(f"[3] unknown card {name!r}: bound computed with H100 SXM rates")
    return CARDS[2][1], CARDS[2][2], "H100 SXM (assumed)"


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
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


def preprocess_work(n: int, in_hw, size: int, out_bytes: int):
    """(bytes, FLOPs) K1 needs for n frames: each input byte read once, each output
    written once; multiply-adds over the resize matrices' nonzeros (the rows the
    height pass reads), plus the normalise."""
    import numpy as np

    from embodied_clip_tpu_torch.ops.resize import resize_plan

    wh, ww = resize_plan(in_hw, size, (size, size))
    rows_needed = int((np.abs(wh).sum(axis=0) > 0).sum())
    flops_frame = (2 * 3 * (rows_needed * np.count_nonzero(ww) + size * np.count_nonzero(wh))
                   + 2 * size * size * 3)
    nbytes = n * (in_hw[0] * in_hw[1] * 3 + size * size * 3 * out_bytes)
    return nbytes, n * flops_frame


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    import numpy as np

    from embodied_clip_tpu_torch import constants
    from embodied_clip_tpu_torch.models.encoders import build_encoder
    from embodied_clip_tpu_torch.ops.kernels import _build
    from embodied_clip_tpu_torch.ops.kernels import preprocess_kernel as K
    from embodied_clip_tpu_torch.parity import cosine_distance, golden_frames

    profile = "--profile" in argv
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[1] torch {torch.__version__} (CUDA {torch.version.cuda}) on {kind}")
    print(smi)

    t0 = time.perf_counter()
    _build.build(_build.SOURCES)
    print(f"[2] built {', '.join(_build.SOURCES)} in {time.perf_counter() - t0:.2f} s")
    for src in _build.SOURCES:
        for line in _build.build_log(src).splitlines():
            if "ptxas info" in line:
                print(f"[2]   {src}: {line.strip()}")

    # Full-f32 references: cuDNN convs and cuBLAS matmuls default to TF32 otherwise.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("[3] TF32 off (torch.backends.cudnn.allow_tf32 = "
          "torch.backends.cuda.matmul.allow_tf32 = False)")

    # -- 3. K1 against its plain version, at the main path's shape --------------------
    mean, std = constants.CLIP_MEAN, constants.CLIP_STD
    lsb = 1.0 / 255.0 / min(std)
    frames = torch.from_numpy(golden_frames(128)).to(dev)
    worst_lsb = max_abs = 0.0
    cases = [(frames, 224), (torch.from_numpy(golden_frames(4, size=160)[:, :, :120].copy()), 224),
             (torch.from_numpy(golden_frames(4, size=301)[:, :, :299].copy()), 224)]
    for x, size in cases:  # main shape, an upscale, and an odd width (byte loads)
        x = x.to(dev)
        before = K.fused_preprocess.launches
        k32 = K.fused_preprocess(x, size, mean, std, dtype=torch.float32)
        kbf = K.fused_preprocess(x, size, mean, std, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        check(K.fused_preprocess.launches == before + 2, "K1 launch count")
        ref = K.fused_preprocess_reference(x, size, mean, std, dtype=torch.float32)
        err = (k32 - ref).abs()
        flipped = float((err > 0.5 * lsb).float().mean())
        print(f"[3] K1 {tuple(x.shape)} → {size}: max {float(err.max()) / lsb:.4f} LSB, "
              f"flipped {flipped:.2e} (limits {LSB_LIMIT} LSB, {FLIP_LIMIT:g} flipped)")
        check(float(err.max()) <= LSB_LIMIT * lsb and flipped < FLIP_LIMIT,
              f"K1 vs plain version on {tuple(x.shape)}")
        check(torch.equal(kbf, k32.to(torch.bfloat16)), "K1 bf16 == f32 output cast")
        worst_lsb = max(worst_lsb, float(err.max()) / lsb)
        max_abs = max(max_abs, float(err.max()))

    kernel_ms = cuda_ms(lambda: K.fused_preprocess(frames, 224, mean, std), 50)
    plain_ms = cuda_ms(lambda: K.fused_preprocess_reference(frames, 224, mean, std), 10)
    bw, f32_peak, card = card_rates(kind)
    nbytes, flops = preprocess_work(128, (300, 300), 224, 2)
    bytes_ms, ops_ms = nbytes / bw * 1e3, flops / f32_peak * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"[3] K1 batch 128 bf16: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B at {bw:.3g} B/s, "
          f"{flops} FLOP at {f32_peak:.3g} FLOP/s, {card}); "
          f"{nbytes / kernel_ms / 1e6:.1f} GB/s achieved")

    # -- 4. the main path: bf16 BN-folded clip_rn50 serving requests -------------------
    enc = build_encoder("clip_rn50", dtype=torch.bfloat16, device="cuda").fold_bn()
    rng = np.random.RandomState(1)
    reqs = []
    for n, layout in REQUESTS:
        f = rng.randint(0, 256, (n, 300, 300, 3), np.uint8)
        reqs.append(f.reshape(n, 300, 900) if layout == "flat" else f)
    K.fused_preprocess.launches = 0  # count the main path's launches only
    t0 = time.perf_counter()
    outs = [enc.encode(f) for f in reqs]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = K.fused_preprocess.launches
    check(launches == len(REQUESTS), f"K1 launched once per request ({launches})")
    for (n, layout), out in zip(REQUESTS, outs):
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        check(shapes == {"clip_conv": (n, 7, 7, 2048), "clip_avgpool": (n, 2048),
                         "clip_attnpool": (n, 1024)}, f"response shapes {shapes}")
        check(all(v.dtype == torch.bfloat16 and bool(torch.isfinite(v).all())
                  for v in out.values()), f"finite bf16 features for batch {n}")
        print(f"[4] request batch {n} ({layout}): ok")
    print(f"[4] {len(REQUESTS)} requests ({sum(n for n, _ in REQUESTS)} frames, first "
          f"call included) in {serve_s:.3f} s; K1 launches {launches}")

    g8 = golden_frames(8)
    ref = build_encoder("clip_rn50", dtype=torch.float32, device="cuda").encode(g8)
    got = enc.encode(g8)
    cos = {k: cosine_distance(got[k], ref[k]) for k in ref}
    print("[4] bf16 folded vs f32 unfolded (same weights, TF32 off), cosine distance: "
          + ", ".join(f"{k} {v:.3e}" for k, v in cos.items()) + f" (limit {COSINE_LIMIT:g})")
    check(all(v <= COSINE_LIMIT for v in cos.values()), f"cosine ≤ {COSINE_LIMIT}")

    x128 = torch.from_numpy(reqs[-1]).to(dev)
    encode_ms = cuda_ms(lambda: enc.encode(x128), 20)
    print(f"[4] clip_rn50 bf16 folded encode, batch 128 on the device: {encode_ms:.3f} ms, "
          f"{128 / encode_ms * 1e3:.1f} frames/s on {smi}")

    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                enc.encode(x128)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))

    # -- 5. results ----------------------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "fused_preprocess", "route": "cuda",
        "source": "embodied_clip_tpu_torch/csrc/preprocess.cu",
        "replaces": "embodied_clip_tpu/ops/pallas/preprocess_kernel.py:93",
        "launches": launches, "max_abs_err": max_abs, "max_err_lsb": worst_lsb,
        "ms": kernel_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
