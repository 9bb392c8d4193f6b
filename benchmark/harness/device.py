"""The card: its name, power limit, and the table of peaks the rooflines divide by.

Peaks are NVIDIA's H100 SXM data sheet at its 700 W limit, dense (no sparsity), kept
here as a frozen copy (the program's `chip_smoke.CARDS` row "H100" agrees). A card set below 700 W runs slower under load,
so every run prints its power limit beside the peaks.
"""

from __future__ import annotations

import shutil
import subprocess

PEAKS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12, "f16": 989e12, "fp8": 1979e12,
         "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
PEAK_SOURCE = "H100 SXM data sheet, 700 W, dense"


def least_seconds(work: dict) -> float:
    """The least time the card could take: the larger of the operations at each
    precision's peak (summed over precisions) and the bytes at HBM bandwidth."""
    compute = sum(v / PEAKS[p] for p, v in work["ops"].items())
    return max(compute, work["bytes"] / HBM_BYTES_PER_S)


def compute_seconds(work: dict) -> float:
    return sum(v / PEAKS[p] for p, v in work["ops"].items())


def power_limit() -> str:
    smi = shutil.which("nvidia-smi")
    if not smi:
        return "unknown"
    try:
        out = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"
