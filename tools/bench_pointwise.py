#!/usr/bin/env python3
"""The per-element launches of the ViT blocks on the card (`chip_smoke.py` phase 16 alone).

    python3 tools/bench_pointwise.py

Builds the kernels a ViT encode runs (K1, the attention launch, the LayerNorm and
QuickGELU launches), prints ptxas's registers of `pointwise_bf16`, then holds each launch
to its plain chain, times it at ViT-L/14@336px's batch 128 beside its bytes bound, times a
batch-128 encode with the launches and with the plain chains in turns, and counts the
launches of a batch-8 encode (`chip_smoke.check_pointwise`). Writes
chiprun_out/bench_pointwise.json. Needs a CUDA device.
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
        print("bench_pointwise: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as S

    from embodied_clip_tpu_torch.ops.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    _build.build(("preprocess", "attention_bf16", "pointwise_bf16"))
    for line in _build.build_log("pointwise_bf16").splitlines():
        if "ptxas info    : Used" in line or "spill" in line:
            print(f"pointwise_bf16: {line.strip()}")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": smi, **S.check_pointwise(S.card_rates(torch.cuda.get_device_name(0)), smi)}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "bench_pointwise.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"ok": True, "batch_ms": out["batch_ms"],
                      "encode_ms_batch128": out["encode_ms_batch128"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
