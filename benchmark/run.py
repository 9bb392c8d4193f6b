#!/usr/bin/env python3
"""The port's benchmark, one run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It makes the cell's weights and inputs from the seed on the card, builds the program
(`embodied_clip_tpu_torch`) through its public entries, warms up the cell's own
shapes, measures for `--seconds`, judges the window's outputs against the plain
float32 reference, and prints one JSON line last on standard output (its checks, each
number beside its limit, are also the last lines on standard error). It fails, and
prints no result, without a card, with fewer cards than the cell asks for, or if JAX
or the JAX package was loaded. A cell on n cards runs as n processes, one a card, this
one rank 0 (`harness/ranks.py`); a failure in any of them ends them all with no
result. Run it from the root of a checkout.
"""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # Build and kernel caches live inside the checkout, at fixed paths.
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import ranks
    from benchmark.harness.cell import resolve

    cell = resolve(args.workload)
    if cell.chips > 1:
        ranks.spawn(cell.chips, cell.traffic["driver"], "cuda")
    from benchmark.harness.runner import log, process_start

    started = process_start()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        ranks.discard()
        log(f"[bench] {args.workload} needs {cell.chips} CUDA card(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    return finish(cell, args.seed, args.seconds, bool(args.trace), "cuda", started)


def finish(cell, seed: int, seconds: float, trace: bool, device: str, started=None) -> int:
    """The run after the look for cards: run it, refuse a result if JAX was loaded,
    print each check beside its limit on standard error and the result line last."""
    from benchmark.harness.runner import forbidden_loaded, log, run

    result, checks = run(cell, seed, seconds, trace, device, started=started)
    loaded = forbidden_loaded()
    if loaded:
        log(f"[bench] the run loaded {', '.join(loaded)}: no result")
        return 3
    for name, c in checks.items():
        log(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
