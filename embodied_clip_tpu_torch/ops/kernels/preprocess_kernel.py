"""Kernel K1: fused uint8 → resized / PIL-quantised / normalised frames.

Replaces `embodied_clip_tpu/ops/pallas/preprocess_kernel.py:fused_preprocess_pallas`.
The CUDA source is `embodied_clip_tpu_torch/csrc/preprocess.cu`; its header states the
bound and the design. This module holds

  - `tap_plan`: the host-side tap tables the kernel reads (the sparse form of the
    resize matrices) and the row tiling that sizes its shared memory;
  - `fused_preprocess`: the wrapper. A CUDA tensor launches the kernel (or raises); a
    CPU tensor, and only a CPU tensor, takes the plain version;
  - `fused_preprocess_reference`: the plain version, the same math in torch f32 with
    dense Kron matrices. The CPU tests use it and the card checks the kernel with it.

`fused_preprocess.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from embodied_clip_tpu_torch.ops.resize import resize_plan

__all__ = ["TapPlan", "tap_plan", "fused_preprocess", "fused_preprocess_reference"]

# Output rows per block before halving to fit shared memory (at 300→224 a tile of 16
# rows needs ~28 input rows: 28 · (900 + 672) B ≈ 44 KB).
_ROWS_PER_TILE = 16
_SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block can opt in to


@dataclasses.dataclass(frozen=True)
class TapPlan:
    """Sparse resize plan: output index i reads inputs start[i] .. start[i]+T-1."""

    w_start: np.ndarray    # (S,) int32
    w_taps: np.ndarray     # (S, Tw) float32
    h_start: np.ndarray    # (S,) int32
    h_taps: np.ndarray     # (S, Th) float32
    rows_per_tile: int
    tile_in0: np.ndarray   # (n_tiles,) int32: first input row of each output-row tile
    tile_span: np.ndarray  # (n_tiles,) int32: input rows the tile needs
    smem_bytes: int

    @property
    def max_span(self) -> int:
        return int(self.tile_span.max())


def _taps(m: np.ndarray):
    """(O, I) resampling matrix → (start (O,), taps (O, T)) holding every nonzero.

    T is the widest nonzero support of any row (sized from the plan: it grows for
    upscales and strong downscales). Starts are clamped so start + T ≤ I."""
    n_out, n_in = m.shape
    first = np.empty(n_out, np.int64)
    last = np.empty(n_out, np.int64)
    for o in range(n_out):
        nz = np.flatnonzero(m[o])
        first[o], last[o] = (nz[0], nz[-1]) if nz.size else (0, 0)
    t = int((last - first).max()) + 1
    start = np.minimum(first, n_in - t)
    taps = np.stack([m[o, s:s + t] for o, s in enumerate(start)]).astype(np.float32)
    return start.astype(np.int32), taps


def _tiles(h_start: np.ndarray, th: int, rows: int):
    size = h_start.shape[0]
    in0, span = [], []
    for r0 in range(0, size, rows):
        hs = h_start[r0:r0 + rows]
        in0.append(int(hs.min()))
        span.append(int(hs.max()) + th - int(hs.min()))
    return np.asarray(in0, np.int32), np.asarray(span, np.int32)


@functools.lru_cache(maxsize=16)
def tap_plan(in_hw: tuple, size: int, method: str = "bicubic") -> TapPlan:
    """Tap tables + row tiling for resize (and centre crop) of `in_hw` to size²."""
    wh, ww = resize_plan(tuple(in_hw), size, (size, size), method)
    w_start, w_taps = _taps(ww)
    h_start, h_taps = _taps(wh)
    row_bytes = (in_hw[1] + size) * 3  # one input row + one width-pass row, uint8
    rows = _ROWS_PER_TILE
    while True:
        tile_in0, tile_span = _tiles(h_start, h_taps.shape[1], rows)
        smem = int(tile_span.max()) * row_bytes
        if smem <= _SMEM_LIMIT:
            break
        if rows == 1:
            raise ValueError(f"fused preprocess: {in_hw} → {size} needs {smem} B of "
                             f"shared memory per output row, above {_SMEM_LIMIT}")
        rows //= 2
    return TapPlan(w_start, w_taps, h_start, h_taps, rows, tile_in0, tile_span, smem)


def _norm_consts(mean, std):
    """Per-channel (1/(255·std), mean/std) in float32, as the TPU kernel folds them."""
    std = np.asarray(std, np.float32)
    inv = (1.0 / (255.0 * std)).astype(np.float32)
    shift = (np.asarray(mean, np.float32) / std).astype(np.float32)
    return inv, shift


@functools.lru_cache(maxsize=16)
def _dense_plan(in_hw: tuple, size: int, method: str):
    wh, ww = resize_plan(tuple(in_hw), size, (size, size), method)
    ww3 = np.kron(ww, np.eye(3, dtype=np.float32)).astype(np.float32)  # (S*3, W*3)
    return wh, np.ascontiguousarray(ww3.T)


def fused_preprocess_reference(frames: torch.Tensor, size: int, mean, std,
                               method: str = "bicubic",
                               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain torch f32 version of K1, on any device: uint8 NHWC → (N, size, size, 3)."""
    n, h, w, _ = frames.shape
    wh, ww3t = _dense_plan((h, w), size, method)
    dev = frames.device
    x = frames.reshape(n, h, w * 3).to(torch.float32)
    a = torch.matmul(x, torch.as_tensor(ww3t, device=dev))          # (n, h, S*3)
    a = torch.clamp(torch.round(a), 0.0, 255.0)
    b = torch.matmul(torch.as_tensor(wh, device=dev), a)            # (n, S, S*3)
    b = torch.clamp(torch.round(b), 0.0, 255.0)
    inv, shift = _norm_consts(mean, std)
    inv = torch.as_tensor(np.tile(inv, size), device=dev)
    shift = torch.as_tensor(np.tile(shift, size), device=dev)
    return (b * inv - shift).to(dtype).reshape(n, size, size, 3)


@functools.lru_cache(maxsize=16)
def _device_tables(in_hw: tuple, size: int, method: str, device: torch.device):
    plan = tap_plan(in_hw, size, method)
    arrays = (plan.w_start, plan.w_taps, plan.h_start, plan.h_taps, plan.tile_in0,
              plan.tile_span)
    return plan, tuple(torch.as_tensor(a).to(device) for a in arrays)


@functools.lru_cache(maxsize=1)
def _lib():
    from embodied_clip_tpu_torch.ops.kernels import _build

    lib = _build.load("preprocess")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ect_fused_preprocess.argtypes = ([p] * 8 + [i] * 11 + [f] * 6 + [i, p])
    lib.ect_fused_preprocess.restype = ctypes.c_int
    lib.ect_error_string.argtypes = [ctypes.c_int]
    lib.ect_error_string.restype = ctypes.c_char_p
    return lib


def fused_preprocess(frames: torch.Tensor, size: int, mean, std,
                     method: str = "bicubic",
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 NHWC frames → normalized (N, size, size, 3) in `dtype`, one kernel launch.

    A CUDA tensor launches K1; a CPU tensor takes `fused_preprocess_reference`."""
    if frames.device.type == "cpu":
        return fused_preprocess_reference(frames, size, mean, std, method, dtype)
    if frames.device.type != "cuda":
        raise ValueError(f"fused preprocess: no kernel for device {frames.device}")
    if frames.dtype != torch.uint8 or frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError("fused preprocess expects uint8 (N, H, W, 3) frames, got "
                         f"{frames.dtype} {tuple(frames.shape)}")
    if not frames.is_contiguous():
        raise ValueError("fused preprocess expects contiguous frames")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused preprocess writes float32 or bfloat16, not {dtype}")
    n, h, w, _ = frames.shape
    out = torch.empty((n, size, size, 3), dtype=dtype, device=frames.device)
    if n == 0:
        return out
    plan, tabs = _device_tables((h, w), size, method, frames.device)
    inv, shift = _norm_consts(mean, std)
    vec4 = (w * 3) % 4 == 0 and frames.data_ptr() % 4 == 0
    lib = _lib()
    err = lib.ect_fused_preprocess(
        frames.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in tabs),
        n, h, w, size, plan.w_taps.shape[1], plan.h_taps.shape[1],
        plan.rows_per_tile, len(plan.tile_in0), plan.max_span, int(vec4),
        int(dtype == torch.bfloat16), *(float(v) for v in inv),
        *(float(v) for v in shift), frames.device.index or 0,
        torch.cuda.current_stream(frames.device).cuda_stream)
    if err:
        raise RuntimeError("fused preprocess kernel launch failed: "
                           + lib.ect_error_string(err).decode())
    fused_preprocess.launches += 1
    return out


fused_preprocess.launches = 0
