#!/usr/bin/env python3
"""Time kernel K2 (`embodied_clip_tpu_torch/csrc/stem_int8.cu`) at the main path's shape
on one NVIDIA GPU in both requant forms, beside a diagnostic build of the same source
that shows what its epilogue costs.

    python3 tools/bench_stem.py [--n 128]

The input is stem2's output of a batch-`n` `clip_rn50` encode: (n, 112, 112, 32) bf16
NHWC, made from seed 0, with a random 3×3 kernel (32 → 64), bias and scale. The tool
builds, with the repository's nvcc flags, and runs

  * `kernel`: the source as it is, dividing by s (its output held to the plain version:
    ≤1 s8 step on ≤0.5% of elements);
  * `reciprocal`: the same library's reciprocal-requant instantiation (`recip=1`),
    multiplying by 1/s, held to the plain version in that form;
  * `no requant`: a build whose requant returns the low bits of the accumulator (a
    diagnostic only): what the products, the pool's shuffles and the stores take
    without the per-pixel requant;

and times each as back-to-back launches between CUDA events, in turns (kernel,
reciprocal, no requant, no requant, reciprocal, kernel), keeping each one's least time.
Prints one JSON line and writes it to chiprun_out/bench_stem.json. Exits non-zero
without a CUDA device, or when the kernel disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_REQUANT = ("const float v = __fadd_rn(acc, b);\n"
            "  float y = __fadd_rn(RECIP ? __fmul_rn(v, s) : __fdiv_rn(v, s), 0.5f);")
BUILDS = {
    "kernel": None,
    "no requant": "float y = acc;\n  return static_cast<uint32_t>(__float_as_int(y)) & 0x7fu;",
}
VARIANTS = {"kernel": ("kernel", 0), "reciprocal": ("kernel", 1),
            "no requant": ("no requant", 0)}  # name → (build, recip)


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


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_stem: no CUDA device is available", file=sys.stderr)
        return 1
    from embodied_clip_tpu_torch.ops.kernels import _build
    from embodied_clip_tpu_torch.ops.kernels import stem_kernel as SK

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128)
    opts = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(opts.n, 112, 112, 32, generator=gen).abs() * 0.5).to("cuda", torch.bfloat16)
    kernel = (torch.randn(3, 3, 32, 64, generator=gen) * 0.1).cuda()
    bias = (torch.randn(64, generator=gen) * 0.05).cuda()
    scale = torch.tensor(2.3 / 127, device="cuda")
    wmat = SK.stem3_weight_matrix(kernel)
    out = torch.empty((opts.n, 56, 56, 64), dtype=torch.int8, device="cuda")

    src = (_build.CSRC / "stem_int8.cu").read_text()
    if _REQUANT not in src:
        raise RuntimeError("stem_int8.cu: the requant line the diagnostics replace has changed")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    libs = {}
    for name, line in BUILDS.items():
        path = _build.BUILD_DIR / f"stem_int8_{name.replace(' ', '_')}.cu"
        path.write_text(src if line is None else src.replace(_REQUANT, line))
        lib = ctypes.CDLL(_build.build_variant(str(path), "stem")[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ect_stem3_requant_pool.argtypes = [p] * 5 + [i] * 6 + [i, p]
        libs[name] = lib

    def run(name):
        build, recip = VARIANTS[name]
        err = libs[build].ect_stem3_requant_pool(
            x.data_ptr(), wmat.data_ptr(), bias.data_ptr(), scale.data_ptr(), out.data_ptr(),
            opts.n, 112, 112, 32, 64, recip, 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"stem3 launch failed: {err}")

    vs_plain = {}
    for name in ("kernel", "reciprocal"):
        run(name)
        want = SK.stem3_requant_pool_int8_reference(x, kernel, bias, scale,
                                                    recip=name == "reciprocal")
        d = (out.int() - want.int()).abs()
        vs_plain[name] = {"worst_step": int(d.max()),
                          "share_differing": float((d != 0).float().mean())}
    times = {}
    for name in list(VARIANTS) + list(reversed(VARIANTS)):
        times.setdefault(name, []).append(cuda_ms(lambda: run(name)))
    best = {k: min(v) for k, v in times.items()}
    result = {"card": smi, "shape": list(x.shape), "ms": best, "runs_ms": times,
              "vs_plain": vs_plain,
              "requant_share": 1 - best["no requant"] / best["kernel"],
              "division_share": 1 - best["reciprocal"] / best["kernel"]}
    print(json.dumps(result))
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/bench_stem.json", "w") as f:
        json.dump(result, f, indent=1)
    return 0 if all(v["worst_step"] <= 1 and v["share_differing"] <= 0.005
                    for v in vs_plain.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
