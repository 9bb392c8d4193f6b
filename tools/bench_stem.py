#!/usr/bin/env python3
"""Time the int8 CLIP stem's two launches (`embodied_clip_tpu_torch/csrc/stem_int8.cu`) at
the main path's shapes on one NVIDIA GPU: kernel K2 in both requant forms beside a
diagnostic build that shows what its epilogue costs, and the stem12 launch (stem1 + stem2
in f32 FMA) beside its bound, its plain version and cuDNN's two f32 convs alone.

    python3 tools/bench_stem.py [--n 128] [--source a.cu,b.cu]

K2's input is stem2's output of a batch-`n` `clip_rn50` encode: (n, 112, 112, 32) bf16
NHWC, made from seed 0, with a random 3×3 kernel (32 → 64), bias and scale. The tool
builds, with the repository's nvcc flags, and runs

  * `kernel`: the source as it is, dividing by s (its output held to the plain version:
    ≤1 s8 step on ≤0.5% of elements);
  * `reciprocal`: the same library's reciprocal-requant instantiation (`recip=1`),
    multiplying by 1/s, held to the plain version in that form;
  * `no requant`: a build whose requant returns the low bits of the accumulator (a
    diagnostic only): what the products, the pool's shuffles and the stores take
    without the per-pixel requant.

stem12's input is the batch-`n` preprocessed frames, (n, 224, 224, 3) bf16 NHWC from seed
0, with random stem1 (3 → 32) and stem2 (32 → 32) kernels and biases:

  * `kernel`: the wrapper `stem12_f32` on the repository's source (its device time also
    from a CUDA-graph replay, and ptxas's registers and spills from the build log);
  * each `--source` file: another version of `stem_int8.cu` with the same C interface
    (`ect_stem12_f32`), built with the repository's nvcc flags;
  * `plain`: `stem12_f32_reference` on the card (the int8 graph's route before stem12:
    two cuDNN convs with the casts, bias and ReLU passes around them);
  * `library`: the two cuDNN f32 convs alone, as the plain route calls them (full f32, on
    inputs made beforehand).
Each stem12 version is held to the plain version with `parity.stem12_step_disagreement`;
its bound is the two convs' operations at the H100's 67 TFLOP/s of f32 FMA (bytes take
less).

Each launch is timed as back-to-back calls between CUDA events, in turns (each version,
then the same in reverse), keeping each one's least time. Prints one JSON line and writes
it to chiprun_out/bench_stem.json. Exits non-zero without a CUDA device, or when a
version disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

F32_FMA_PEAK = 67e12  # H100 SXM, f32 outside the tensor cores (NVIDIA's data sheet)
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


def graph_ms(fn, iters=20):
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


def in_turns(runs, iters=lambda name: 20):
    """{name: [ms, ms]} for runs timed in turns, forwards then in reverse."""
    times = {}
    for name in list(runs) + list(reversed(runs)):
        times.setdefault(name, []).append(cuda_ms(runs[name], iters(name)))
    return times


def bench_k2(n):
    import torch

    from embodied_clip_tpu_torch.ops.kernels import _build
    from embodied_clip_tpu_torch.ops.kernels import stem_kernel as SK

    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(n, 112, 112, 32, generator=gen).abs() * 0.5).to("cuda", torch.bfloat16)
    kernel = (torch.randn(3, 3, 32, 64, generator=gen) * 0.1).cuda()
    bias = (torch.randn(64, generator=gen) * 0.05).cuda()
    scale = torch.tensor(2.3 / 127, device="cuda")
    wmat = SK.stem3_weight_matrix(kernel)
    out = torch.empty((n, 56, 56, 64), dtype=torch.int8, device="cuda")

    src = (_build.CSRC / "stem_int8.cu").read_text()
    if _REQUANT not in src:
        raise RuntimeError("stem_int8.cu: the requant line the diagnostics replace has changed")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    libs = {}
    for name, line in BUILDS.items():
        path = _build.BUILD_DIR / f"stem_int8_{name.replace(' ', '_')}.cu"
        path.write_text(src if line is None else src.replace(_REQUANT, line))
        libs[name] = SK.LIB.variant(_build.build_variant(str(path), "stem")[0])

    def launch(name):
        build, recip = VARIANTS[name]
        libs[build].ect_stem3_requant_pool(
            x.data_ptr(), wmat.data_ptr(), bias.data_ptr(), scale.data_ptr(), out.data_ptr(),
            n, 112, 112, 32, 64, recip, *_build.stream(x))

    vs_plain = {}
    for name in ("kernel", "reciprocal"):
        launch(name)
        want = SK.stem3_requant_pool_int8_reference(x, kernel, bias, scale,
                                                    recip=name == "reciprocal")
        d = (out.int() - want.int()).abs()
        vs_plain[name] = {"worst_step": int(d.max()),
                          "share_differing": float((d != 0).float().mean())}
    times = in_turns({name: (lambda name=name: launch(name)) for name in VARIANTS})
    best = {k: min(v) for k, v in times.items()}
    ok = all(v["worst_step"] <= 1 and v["share_differing"] <= 0.005 for v in vs_plain.values())
    return ok, {"shape": list(x.shape), "ms": best, "runs_ms": times, "vs_plain": vs_plain,
                "requant_share": 1 - best["no requant"] / best["kernel"],
                "division_share": 1 - best["reciprocal"] / best["kernel"]}


def bench_stem12(n, sources):
    import torch
    import torch.nn.functional as F

    from embodied_clip_tpu_torch.ops.int8 import full_f32
    from embodied_clip_tpu_torch.ops.kernels import _build
    from embodied_clip_tpu_torch.ops.kernels import stem_kernel as SK
    from embodied_clip_tpu_torch.parity import (
        STEM12_SHARE,
        STEM12_STEPS,
        stem12_step_disagreement,
    )

    hw, c = 224, 32
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(n, hw, hw, 3, generator=gen).to("cuda", torch.bfloat16)
    k1 = (torch.randn(3, 3, 3, c, generator=gen) * 0.3).cuda()
    b1 = (torch.randn(c, generator=gen) * 0.1).cuda()
    k2 = (torch.randn(3, 3, c, c, generator=gen) * (1.0 / (9 * c) ** 0.5)).cuda()
    b2 = (torch.randn(c, generator=gen) * 0.1).cuda()
    ops = SK.stem12_weights(k1, b1, k2, b2)
    regs, fn = [], ""
    for ln in _build.build_log("stem_int8").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        fn = m.group(1) if m else fn
        if "stem12" in fn and re.search(r"registers|spill", ln):
            regs.append(f"{re.sub(r'.*stem12_kernel', 'stem12_kernel', fn)}: {ln.strip()}")

    runs = {"kernel": lambda: SK.stem12_f32(x, k1, b1, k2, b2, ops=ops)}
    out = torch.empty((n, hw // 2, hw // 2, c), dtype=torch.bfloat16, device="cuda")
    for path in sources:
        lib = SK.LIB.variant(_build.build_variant(path, "stem")[0])

        def launch(lib=lib):
            lib.ect_stem12_f32(x.data_ptr(), 0, ops["w1"].data_ptr(), ops["b1"].data_ptr(),
                               ops["w2"].data_ptr(), ops["b2"].data_ptr(), out.data_ptr(),
                               n, hw, hw, c, *_build.stream(x))
            return out
        runs[os.path.basename(path)] = launch

    want = SK.stem12_f32_reference(x, k1, b1, k2, b2)
    vs_plain = {}
    for name, launch in runs.items():
        share, steps = stem12_step_disagreement(launch(), want)
        vs_plain[name] = {"worst_step": steps, "share_differing": share}
    w1c = k1.to(torch.bfloat16).float().permute(3, 2, 0, 1).contiguous()
    w2c = k2.to(torch.bfloat16).float().permute(3, 2, 0, 1).contiguous()
    xf, t1f = x.float(), want.float()

    def library():
        with full_f32():
            F.conv2d(xf.permute(0, 3, 1, 2), w1c, None, 2, 1)
            F.conv2d(t1f.permute(0, 3, 1, 2), w2c, None, 1, 1)

    times = in_turns({**runs, "plain": lambda: SK.stem12_f32_reference(x, k1, b1, k2, b2),
                      "library": library},
                     lambda name: 10 if name in ("plain", "library") else 20)
    best = {k: min(v) for k, v in times.items()}
    flops = 2 * n * (hw // 2) ** 2 * c * (27 + 9 * c)
    bound_ms = flops / F32_FMA_PEAK * 1e3
    ok = all(v["worst_step"] <= STEM12_STEPS and v["share_differing"] <= STEM12_SHARE
             for v in vs_plain.values())
    return ok, {"shape": list(x.shape), "c": c, "bound_ms": bound_ms, "ms": best,
                "runs_ms": times, "device_ms": graph_ms(runs["kernel"]),
                "share_of_bound": {k: bound_ms / v for k, v in best.items()},
                "vs_plain": vs_plain, "ptxas": regs}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_stem: no CUDA device is available", file=sys.stderr)
        return 1
    from embodied_clip_tpu_torch.ops.kernels import _build

    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--source", default="",
                    help="other versions of stem_int8.cu whose stem12 is timed, comma-separated")
    opts = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _build.build(("stem_int8",))
    k2_ok, k2 = bench_k2(opts.n)
    s12_ok, s12 = bench_stem12(opts.n, list(filter(None, opts.source.split(","))))
    result = {"card": smi, "k2": k2, "stem12": s12}
    print(json.dumps(result))
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/bench_stem.json", "w") as f:
        json.dump(result, f, indent=1)
    return 0 if k2_ok and s12_ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
