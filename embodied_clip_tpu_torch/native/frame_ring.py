"""ctypes binding for the C++ shared-memory frame ring (port of
`embodied_clip_tpu/native/frame_ring.py`).

The ring's source is the repository's `native/frame_ring.cpp`, which the port reads and
never edits. It is compiled with g++ on first use into the port's own git-ignored
`build/native/` at the root of the checkout, under a name that hashes the source and
the flags (as the CUDA kernels are, `ops/kernels/_build.py`). Where g++ or the source
is missing, `frame_ring_available()` returns False and `VectorEnv` pipes frames instead.

Each worker owns one slot and publishes under a per-slot seqlock; `read` copies a
slot into a private numpy array, so what leaves the ring can no longer change under
the reader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import uuid
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["FrameRing", "frame_ring_available", "library_path"]

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "frame_ring.cpp"
BUILD_DIR = _ROOT / "build" / "native"
FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lib: Optional[ctypes.CDLL] = None
_build_attempted = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libframe_ring-{digest[:16]}.so"


def _build(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build the frame ring")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
    subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE), "-lrt"], check=True,
                   capture_output=True, timeout=120)
    os.replace(tmp, out)  # atomic: another process never loads half a library


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_attempted
    if _lib is not None:
        return _lib
    if not SOURCE.exists():
        return None
    path = library_path()
    if not path.exists() and not _build_attempted:
        _build_attempted = True
        try:
            _build(path)
        except (RuntimeError, OSError, subprocess.SubprocessError):
            return None
    if not path.exists():
        return None
    lib = ctypes.CDLL(str(path))
    lib.fr_create.restype = ctypes.c_void_p
    lib.fr_create.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_long]
    lib.fr_attach.restype = ctypes.c_void_p
    lib.fr_attach.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_long]
    lib.fr_write.restype = None
    lib.fr_write.argtypes = [ctypes.c_void_p, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long]
    lib.fr_read.restype = ctypes.c_long
    lib.fr_read.argtypes = [ctypes.c_void_p, ctypes.c_int,
                            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long]
    lib.fr_close.restype = None
    lib.fr_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
    _lib = lib
    return lib


def frame_ring_available() -> bool:
    return _load() is not None


class FrameRing:
    """N fixed-size uint8 frame slots in POSIX shared memory (seqlock per slot)."""

    def __init__(self, handle, name: str, nslots: int, shape: Tuple[int, ...],
                 owner: bool):
        self._h = handle
        self.name = name
        self.nslots = nslots
        self.shape = tuple(shape)
        self.nbytes = int(np.prod(shape))
        self.owner = owner

    @classmethod
    def create(cls, nslots: int, shape: Tuple[int, ...]) -> "FrameRing":
        lib = _load()
        if lib is None:
            raise RuntimeError("the native frame ring is unavailable")
        name = f"/ect_ring_{os.getpid()}_{uuid.uuid4().hex[:8]}"
        h = lib.fr_create(name.encode(), nslots, int(np.prod(shape)))
        if not h:
            raise RuntimeError(f"fr_create({name}) failed")
        return cls(h, name, nslots, shape, owner=True)

    @classmethod
    def attach(cls, name: str, nslots: int, shape: Tuple[int, ...]) -> "FrameRing":
        lib = _load()
        if lib is None:
            raise RuntimeError("the native frame ring is unavailable")
        h = lib.fr_attach(name.encode(), nslots, int(np.prod(shape)))
        if not h:
            raise RuntimeError(f"fr_attach({name}) failed")
        return cls(h, name, nslots, shape, owner=False)

    def attach_info(self):
        return (self.name, self.nslots, self.shape)

    def write(self, slot: int, frame: np.ndarray) -> None:
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.size != self.nbytes:
            raise ValueError(f"frame of shape {frame.shape} for ring slots of {self.shape}")
        ptr = frame.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        _lib.fr_write(self._h, slot, ptr, frame.size)

    def read(self, slot: int) -> np.ndarray:
        out = np.empty(self.shape, dtype=np.uint8)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
        if _lib.fr_read(self._h, slot, ptr, out.size) < 0:
            raise RuntimeError("frame ring read failed")
        return out

    def read_batch(self) -> np.ndarray:
        """Assemble all slots into one contiguous (N, *shape) uint8 batch."""
        out = np.empty((self.nslots,) + self.shape, dtype=np.uint8)
        for i in range(self.nslots):
            ptr = out[i].ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
            _lib.fr_read(self._h, i, ptr, out[i].size)
        return out

    def close(self) -> None:
        if self._h:
            _load().fr_close(self._h, 1 if self.owner else 0)
            self._h = None
