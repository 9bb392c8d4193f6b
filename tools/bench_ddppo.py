#!/usr/bin/env python3
"""Run `chip_smoke.py`'s phase 9 alone on one NVIDIA GPU: the DD-PPO step at the
example's full width (`clip_rn50` inside the rollout, GridNav size 8, 32 envs × 64
steps, hidden 512, 4 PPO epochs), bf16 and int8 path A, in a fresh process where no
earlier phase has run.

    python3 tools/bench_ddppo.py [--turns N]

It builds the kernels, turns TF32 off as `chip_smoke.py` does before its phase 3, and
runs `chip_smoke.check_ddppo`: the same checks and CUDA-event split, with N (default 4)
turns of (plain, instrumented, instrumented, plain) bf16 iterations after the first,
where `chip_smoke.py` takes one. Run
after `chip_smoke.py` in one call, it separates what the step costs from what the
process that ran phases 1-8 first adds to it. Prints one JSON line and writes it to
chiprun_out/bench_ddppo.json. Exits non-zero without a CUDA device or when a check
fails.
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
    ap.add_argument("--turns", type=int, default=4,
                    help="(plain, instrumented, instrumented, plain) bf16 iterations")
    opts = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("bench_ddppo: no CUDA device is available", file=sys.stderr)
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
    result = chip_smoke.check_ddppo(card, smi, profile=False, turns=opts.turns)
    line = json.dumps({"ddppo_alone": result, "card": smi})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "bench_ddppo.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
