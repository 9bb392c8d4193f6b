"""Build the port's CUDA sources (`embodied_clip_tpu_torch/csrc/*.cu`) with nvcc, and
bind their C interfaces.

Each source has a plain C interface and becomes one shared library, loaded with
ctypes. Libraries go to `build/kernels/` at the root of the checkout (listed in
`.gitignore`), named by a hash of the source, the headers of `csrc/` and the flags,
so an edit rebuilds and an unchanged source is compiled once. `build()` starts one
nvcc per source, all at once, and waits for them together.

The C contract every source keeps: an entry point takes its device index and its CUDA
stream last (`stream`) and returns 0 or an error code, which `ect_error_string` names.
`Library` is the one place that knows it: a kernel wrapper declares its source's entry
points once, at import, and calls them; an error raises `RuntimeError`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Mapping, Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
# Every kernel source of the port; chip_smoke.py builds them all before it runs.
SOURCES = ("preprocess", "stem_int8", "bottleneck_int8", "bottleneck_bf16",
           "attention_bf16", "pointwise_bf16")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed")
    return path


def _digest(src: bytes) -> str:
    """Hash of a source, every header of `csrc/` (a source may include any of them) and
    the flags."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    return hashlib.sha256(src + headers + " ".join(FLAGS).encode()).hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest((CSRC / f'{name}.cu').read_bytes())}.so"


def build_variant(path: str, tag: str):
    """Build another version of a source (`path`, anywhere; its `#include`s of `csrc/`
    headers resolve) with the same flags, to compare designs in one run. Returns the
    library's path and nvcc's output; raises if nvcc fails."""
    src = Path(path).read_bytes()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"lib{tag}-variant-{_digest(src)}.so"
    proc = subprocess.run([_nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(lib), str(path)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {path}:\n{proc.stdout}{proc.stderr}")
    return str(lib), proc.stdout + proc.stderr


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


def stream(t: torch.Tensor):
    """(device index, CUDA stream handle) of t's device and its current stream: the last
    two arguments of every entry point."""
    return t.device.index or 0, torch.cuda.current_stream(t.device).cuda_stream


def _launcher(name: str, fn, errors):
    """`fn` (an entry point returning an error code) as a call that raises on an error,
    naming the entry point and the library's own error string."""
    def launch(*args) -> None:
        err = fn(*args)
        if err:
            raise RuntimeError(f"{name} launch failed: {errors(err).decode()}")
    return launch


class Library:
    """The C interface of `csrc/<source>.cu`: `entries` maps each entry point that returns
    an error code to its argument types, `sizes` each one that returns a count (a
    `c_longlong`, such as the size of a scratch buffer) to its own. Nothing is built or
    loaded until an entry point is first used; then the source is built where needed,
    and every entry point is bound once: `lib.<entry>(*args)` launches or raises, and
    `lib.<size>(*args)` returns the count. `variant(path)` is the same interface on a
    library that `build_variant` built from another version of the source."""

    def __init__(self, source: str, entries: Mapping[str, Sequence],
                 sizes: Optional[Mapping[str, Sequence]] = None, path: Optional[str] = None):
        self.source, self.entries, self.sizes, self.path = source, entries, sizes or {}, path

    def variant(self, path: str) -> "Library":
        return Library(self.source, self.entries, self.sizes, path)

    def __getattr__(self, name: str):
        # Reached only for a name not bound yet (or on an instance that has no attributes
        # yet, as while it is copied): the first use binds every entry point.
        entries, sizes = self.__dict__.get("entries", {}), self.__dict__.get("sizes", {})
        if name not in entries and name not in sizes:
            raise AttributeError(name)
        if self.path is None:
            build((self.source,))
        lib = ctypes.CDLL(self.path or str(library_path(self.source)))
        errors = lib.ect_error_string
        errors.argtypes, errors.restype = [ctypes.c_int], ctypes.c_char_p
        for entry, args in self.entries.items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = list(args), ctypes.c_int
            self.__dict__[entry] = _launcher(entry, fn, errors)
        for entry, args in self.sizes.items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = list(args), ctypes.c_longlong
            self.__dict__[entry] = fn
        return self.__dict__[name]
