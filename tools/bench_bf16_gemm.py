#!/usr/bin/env python3
"""Time each launch of the bf16 bottleneck GEMM (K6/K7's kernel,
`embodied_clip_tpu_torch/csrc/bottleneck_bf16.cu`) on the main path, on one NVIDIA GPU.

    python3 tools/bench_bf16_gemm.py [--models clip_rn50,imagenet_rn50] [--source a.cu,b.cu]

For each kernel source (the repository's by default; `--source` builds other versions
of the file with the same nvcc flags, to compare designs in one run) and each model in
`--models` (BN-folded bf16 encoders, random weights from seed 0, golden_frames(128)):

  * holds every K6/K7 call of one batch-128 encode to its plain version with the card
    contract (`parity.bf16_disagreement`, K7 block by block), as chip_smoke.py phase 7;
  * on the first model, times each distinct `_gemm` launch of the encode with CUDA
    events, and prints ms, TFLOP/s and the launch's bound (operations at the dense bf16 peak against its bytes,
    each input read once and the output written once, at the memory rate), then both
    summed by stage: stage 1's launch bounds summed are K7's floor with h1/h2 in device
    memory.

Writes everything to chiprun_out/bench_bf16_gemm.json. Exits non-zero without a CUDA
device, or when a source does not build or breaks the contract.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Card → (device-memory bytes/s, dense bf16 operations/s), NVIDIA data sheets.
CARDS = (("H100 PCIe", 2.0e12, 756e12), ("H100 NVL", 3.9e12, 835e12),
         ("H100", 3.35e12, 989e12), ("H200", 4.8e12, 989e12))


def cuda_ms(fn, iters=20, warmup=3):
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


def work(args, kw):
    """(operations, bytes) of one launch: 2 per multiply-add; each input once."""
    a, w, _, out = args
    m, n = out.numel() // out.shape[-1], out.shape[-1]
    ops = 2 * m * n * (w.numel() // n)
    nbytes = (a.numel() + w.numel() + out.numel()) * 2
    if kw.get("res") is not None:
        nbytes += kw["res"].numel() * 2
    if kw.get("a2") is not None:
        ops += 2 * m * n * kw["w2"].shape[0]
        nbytes += (kw["a2"].numel() + kw["w2"].numel()) * 2
    return ops, nbytes


def check_contract(BK, enc, frames):
    """(worst share, worst ratio) over every K6/K7 call of one encode, as phase 7."""
    import torch

    from embodied_clip_tpu_torch.parity import (
        BF16_KERNEL_SHARE,
        bf16_disagreement,
        stage1_block_disagreements,
    )

    calls, wrapped = [], {}
    for name in ("fused_stage1", "fused_bottleneck"):
        fn = getattr(BK, name)

        def rec(*args, _fn=fn, _name=name, **kw):
            calls.append((_name, args, kw))
            return _fn(*args, **kw)

        rec.launches = 0  # the wrapper counts its launches through the module's name
        wrapped[name] = fn
        setattr(BK, name, rec)
    try:
        enc.encode(frames)
    finally:
        for name, fn in wrapped.items():
            setattr(BK, name, fn)
    share = worst = 0.0
    for name, args, kw in calls:
        if name == "fused_stage1":
            per = stage1_block_disagreements(*args)
        else:
            per = [bf16_disagreement(BK.fused_bottleneck(*args, **kw),
                                     BK.fused_bottleneck_reference(*args, **kw))]
        share = max(share, max(s for s, _ in per))
        worst = max(worst, max(w for _, w in per))
    torch.cuda.synchronize()
    return share, worst, share <= BF16_KERNEL_SHARE and worst <= 1.0


def time_launches(BK, enc, frames, bw, peak):
    import torch

    launches, gemm = [], BK._gemm

    def recording(*args, **kw):
        launches.append((args, kw))
        return gemm(*args, **kw)

    BK._gemm = recording
    try:
        enc.encode(frames)
    finally:
        BK._gemm = gemm
    torch.cuda.synchronize()
    distinct = {}
    for args, kw in launches:
        a, w = args[0], args[1]
        step = "b" if kw.get("conv3") else ("a" if kw.get("res") is None and
                                            kw.get("a2") is None else "c")
        key = (step, tuple(a.shape), tuple(w.shape), kw.get("a2") is not None)
        distinct.setdefault(key, [args, kw, 0])[2] += 1
    rows = []
    for (step, a_shape, w_shape, shortcut), (args, kw, count) in distinct.items():
        ops, nbytes = work(args, kw)
        ms = cuda_ms(lambda: gemm(*args, **kw))
        row = {"step": step, "a": list(a_shape), "w": list(w_shape), "shortcut": shortcut,
               "calls_per_encode": count, "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
               "ms": ms, "tflops": ops / ms / 1e9,
               "bound_ms": max(ops / peak, nbytes / bw) * 1e3,
               "bound_by": "operations" if ops / peak >= nbytes / bw else "bytes"}
        rows.append(row)
        print(f"  ({step}) A {a_shape} W {w_shape}{' +shortcut' if shortcut else ''} ×{count}: "
              f"{ms:.4f} ms ({row['tflops']:.0f} TFLOP/s); bound {row['bound_ms']:.4f} ms "
              f"by {row['bound_by']}")
    # By stage (the input's spatial size): stage 1 is K7's three launches per block, and
    # the sum of their bounds is its floor when h1/h2 go through device memory.
    for hw in sorted({r["a"][1] for r in rows}, reverse=True):
        sel = [r for r in rows if r["a"][1] == hw]
        print(f"  {hw}×{hw} inputs: {sum(r['calls_per_encode'] for r in sel)} launches, "
              f"{sum(r['ms'] * r['calls_per_encode'] for r in sel):.4f} ms; launch bounds "
              f"summed {sum(r['bound_ms'] * r['calls_per_encode'] for r in sel):.4f} ms")
    total = sum(r["ms"] * r["calls_per_encode"] for r in rows)
    bound = sum(r["bound_ms"] * r["calls_per_encode"] for r in rows)
    return len(launches), rows, total, bound


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_bf16_gemm: no CUDA device is available", file=sys.stderr)
        return 1
    from embodied_clip_tpu_torch.models.encoders import build_encoder
    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
    from embodied_clip_tpu_torch.ops.kernels import _build
    from embodied_clip_tpu_torch.parity import golden_frames

    ap = argparse.ArgumentParser()
    ap.add_argument("--models", default="clip_rn50,imagenet_rn50")
    ap.add_argument("--source", default="", help="comma-separated .cu files to compare")
    opts = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    _, bw, peak = next((c for c in CARDS if c[0] in kind), CARDS[2])
    print(f"torch {torch.__version__} on {smi}")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    frames = torch.from_numpy(golden_frames(128)).cuda()
    encoders = {m: build_encoder(m, dtype=torch.bfloat16, device="cuda").fold_bn()
                for m in opts.models.split(",")}
    sources = opts.source.split(",") if opts.source else [
        str(_build.CSRC / "bottleneck_bf16.cu")]
    repo_lib = BK.LIB_BF16
    results, ok_all = [], True
    for path in sources:
        lib_path, log = _build.build_variant(path, "bf16")
        BK.LIB_BF16 = repo_lib.variant(lib_path)
        warn = sorted({line.split(")")[0] + ")" for line in log.splitlines() if "(C7" in line})
        regs = [line.split(":")[-1].strip() for line in log.splitlines() if "Used" in line]
        print(f"{path}: ptxas {regs}; warnings {warn or 'none'}")
        entry = {"source": path, "ptxas": regs, "warnings": warn, "contract": {}}
        try:
            with torch.inference_mode():
                for i, (model, enc) in enumerate(encoders.items()):
                    share, worst, ok = check_contract(BK, enc, frames)
                    ok_all &= ok
                    entry["contract"][model] = {"share": share, "worst": worst, "ok": ok}
                    print(f" {model}: K6/K7 worst share {share:.3e}, worst {worst:.3f} of the "
                          f"allowance ({'holds' if ok else 'BROKEN'})")
                    if i == 0:
                        n, rows, total, bound = time_launches(BK, enc, frames, bw, peak)
                        print(f" {model}: {n} GEMM launches per batch-128 encode, summed "
                              f"{total:.4f} ms; launch bounds summed {bound:.4f} ms; on {smi}")
                        entry.update(model=model, launches=n, rows=rows, summed_ms=total,
                                     bound_ms=bound)
        finally:
            BK.LIB_BF16 = repo_lib
        results.append(entry)
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/bench_bf16_gemm.json", "w") as f:
        json.dump({"card": smi, "torch": torch.__version__, "results": results}, f, indent=1)
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
