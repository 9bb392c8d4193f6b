#!/usr/bin/env python3
"""Where the CLIP transformer family's time goes on the card, and how far the bf16
bottleneck kernel is from exact arithmetic at RN50x16's widths.

    python3 tools/bench_clip_family.py

1. ViT-B/32 batch-128 encodes of golden frames, bf16 and int8 (calibrated on
   golden_frames(32)): CUDA-event ms in turns (bf16, int8, int8, bf16), then a
   torch.profiler table of 3 encodes each and the device-busy ms per encode;
2. the s8 product at the int8 ViT's MLP shape (6400, 768) × (768, 3072): `ops/int8.qmm`
   (the weight column-major, as the int8 ViT passes it), `torch._int_mm` with a
   row-major weight, and the bf16 product of the same shape;
3. every K6 call of a folded bf16 `clip_rn50` encode (batch 32) and `clip_rn50x16`
   encode (batch 8), the kernel and its plain version each against the same
   arithmetic accumulated in float64 (`chip_smoke.exact_disagreements`).

Writes chiprun_out/bench_clip_family.json. Needs a CUDA device; builds the kernels
first.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_clip_family: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as S
    from torch.profiler import ProfilerActivity, profile

    from embodied_clip_tpu_torch.models.encoders import build_encoder
    from embodied_clip_tpu_torch.ops.int8 import qmm
    from embodied_clip_tpu_torch.ops.kernels import _build
    from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
    from embodied_clip_tpu_torch.parity import bf16_disagreement, golden_frames

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    _build.build(_build.SOURCES)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": smi}

    # 1. ViT-B/32 encodes
    vit = build_encoder("clip_vit_b32", dtype=torch.bfloat16, device="cuda")
    encoders = {"bf16": vit, "int8": vit.quantize(golden_frames(32))}
    x = torch.from_numpy(golden_frames(128)).cuda()
    times = {}
    for label in ("bf16", "int8", "int8", "bf16"):
        times.setdefault(label, []).append(S.cuda_ms(lambda: encoders[label].encode(x), 10))
    out["vit_encode_ms_batch128"] = times
    print(f"ViT-B/32 batch-128 encode ms, in turns: {times}")
    for label, enc in encoders.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                enc.encode(x)
            torch.cuda.synchronize()
        busy = S.busy_ms(prof) / 3
        out[f"vit_{label}_device_busy_ms"] = busy
        print(f"=== ViT-B/32 {label}: 3 encodes at batch 128, device busy {busy:.3f} ms an "
              f"encode; device time by op:")
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=20,
                                        max_name_column_width=60))

    # 2. the s8 product at the MLP shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randint(-127, 128, (6400, 768), generator=gen, device="cuda", dtype=torch.int8)
    w = torch.randint(-127, 128, (3072, 768), generator=gen, device="cuda", dtype=torch.int8)
    ab, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
    w_rows = w.t().contiguous()
    gemms = {}
    for label, fn in (("qmm, weight column-major", lambda: qmm(a, w.t())),
                      ("torch._int_mm, weight row-major", lambda: torch._int_mm(a, w_rows)),
                      ("bf16 matmul", lambda: ab @ wb.t())):
        ms = S.cuda_ms(fn, 20)
        gemms[label] = {"ms": ms, "tops": 2 * 6400 * 768 * 3072 / ms / 1e9}
        print(f"(6400, 768) x (768, 3072) {label}: {ms:.4f} ms, "
              f"{gemms[label]['tops']:.1f} TOP/s; {smi}")
    out["mlp_gemm"] = gemms

    # 3. K6 against float64 arithmetic
    out["k6_vs_float64"] = {}
    for name, n in (("clip_rn50", 32), ("clip_rn50x16", 8)):
        enc = build_encoder(name, dtype=torch.bfloat16, device="cuda").fold_bn()
        frames = torch.from_numpy(golden_frames(n)).cuda()
        with torch.inference_mode():
            with S.Recorder(BK, "fused_bottleneck") as r6:
                enc.encode(frames)
            rows = []
            for args, kw, _ in r6.calls:
                got = BK.fused_bottleneck(args[0], **kw)
                plain = BK.fused_bottleneck_reference(args[0], **kw)
                rows.append({"shape": list(args[0].shape),
                             "kernel_plain": bf16_disagreement(got, plain)[0],
                             "kernel_vs_f64_plain_vs_f64": S.exact_disagreements(args, kw)})
        out["k6_vs_float64"][name] = rows
        for r in rows:
            print(f"{name} K6 {tuple(r['shape'])}: kernel vs plain {r['kernel_plain']:.3e} "
                  f"of elements differ; vs float64: kernel "
                  f"{r['kernel_vs_f64_plain_vs_f64'][0]:.3e}, plain "
                  f"{r['kernel_vs_f64_plain_vs_f64'][1]:.3e}")
        del enc
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "bench_clip_family.json"), "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
