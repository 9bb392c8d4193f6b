"""Build the port's CUDA sources (`embodied_clip_tpu_torch/csrc/*.cu`) with nvcc.

Each source has a plain C interface and becomes one shared library, loaded with
ctypes. Libraries go to `build/kernels/` at the root of the checkout (listed in
`.gitignore`), named by a hash of the source and the flags, so an edit rebuilds and
an unchanged source is compiled once. `build()` starts one nvcc per source, all at
once, and waits for them together.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
# Every kernel source of the port; chip_smoke.py builds them all before it runs.
SOURCES = ("preprocess", "stem_int8", "bottleneck_int8", "bottleneck_bf16")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_log(name: str) -> str:
    """nvcc's output (with ptxas's register and shared-memory report) for `name`."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names=SOURCES) -> None:
    """Compile every source in `names` whose library is missing, in parallel."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with contextlib.ExitStack() as stack:
        jobs = []
        for name in todo:
            out = library_path(name)
            tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
            log = stack.enter_context(open(out.with_suffix(".log"), "w"))
            proc = subprocess.Popen([nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                                    stdout=log, stderr=subprocess.STDOUT)
            jobs.append((name, proc, tmp, out))
        failed = []
        for name, proc, tmp, out in jobs:
            if proc.wait() == 0:
                os.replace(tmp, out)  # atomic: a reader never sees half a library
            else:
                failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{n}.cu:\n{build_log(n)}" for n in failed))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu`, compiled first where needed."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))
