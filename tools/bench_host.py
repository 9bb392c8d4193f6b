#!/usr/bin/env python3
"""Run `chip_smoke.py`'s phase 10 alone on one NVIDIA GPU: the host-simulator path at
full width (pools of 8 THOR worker processes over the scripted controller of
tests/fake_thor.py at 300×300, the bf16 folded and int8 `clip_rn50`, the allenact policy
with hidden 512, rollout 64), in a fresh process where no earlier phase has run.

    python3 tools/bench_host.py [--profile]

It builds the kernels, turns TF32 off as `chip_smoke.py` does before its phase 3, and
runs `chip_smoke.check_host_path`: the same checks, splits and env-steps/s; `--profile`
adds the device-busy share of one rollout and one update. Run beside `chip_smoke.py` in
one call, it separates what the path costs from what the process that ran phases 1-9
first adds to it. Prints one JSON line and writes it to chiprun_out/bench_host.json.
Exits non-zero without a CUDA device or when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="the device-busy share of one rollout and one update")
    opts = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("bench_host: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke
    from embodied_clip_tpu_torch.ops.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    _build.build(_build.SOURCES)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_rates(torch.cuda.get_device_name(0))
    result = chip_smoke.check_host_path(card, smi, profile=opts.profile)
    line = json.dumps({"host_alone": result, "card": smi})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "bench_host.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
