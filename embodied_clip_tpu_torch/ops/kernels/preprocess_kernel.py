"""Kernel K1: fused uint8 → resized / PIL-quantised / normalised frames.

Replaces `embodied_clip_tpu/ops/pallas/preprocess_kernel.py:fused_preprocess_pallas`.
The CUDA source is `embodied_clip_tpu_torch/csrc/preprocess.cu`; its header states the
bound and the design. This module holds

  - `tap_plan`: the host-side tap tables the kernel reads (the sparse form of the
    resize matrices, padded to a compiled tap count), the width pass's thread
    assignment and the band and ring sizes that fix its shared memory; `work_items`:
    the chunks of output rows, sized from the batch, and the persistent grid;
    `item_bands`, `rows_done`, `band_copy`: a chunk's bands, the output rows a band
    completes, and the 16-byte-aligned bytes the kernel's bulk copy moves for a band;
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

from embodied_clip_tpu_torch.ops.kernels._build import Library, stream
from embodied_clip_tpu_torch.ops.resize import resize_plan

__all__ = ["TapPlan", "tap_plan", "work_items", "item_bands", "rows_done", "band_copy",
           "fused_preprocess", "fused_preprocess_reference"]

# Must match csrc/preprocess.cu: its tap counts and pair gaps (template instances),
# threads per block, blocks per SM its registers allow (__launch_bounds__), stages of the
# copy ring and mbarrier bytes.
TAP_COUNTS = (4, 6, 12, 24)  # upscales, the main path, strong downscales
PAIR_GAPS = (2, 8)
THREADS = 256
BLOCKS_PER_SM = 2
STAGES = 3
_BARRIER_BYTES = 128
# Input rows per band, largest first: the plan takes the largest whose shared memory
# lets BLOCKS_PER_SM blocks share an SM, else fewer blocks.
_BAND_ROWS = (16, 12, 8, 6, 4, 3, 2, 1)
_SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block can opt in to
_SM_SMEM = 233_472     # shared memory of one Hopper SM; each block also reserves 1 KB
_BLOCK_RESERVED = 1024
_BANK_GROUPS = 16      # 8-byte units a half-warp's 64-bit shared loads spread over


@dataclasses.dataclass(frozen=True)
class TapPlan:
    """Sparse resize plan: output index i reads inputs start[i] .. start[i]+taps-1; the
    width pass's thread assignment; and the kernel's shared-memory layout for it."""

    w_start: np.ndarray    # (S,) int32
    w_taps: np.ndarray     # (S, taps) float32
    h_start: np.ndarray    # (S,) int32, non-decreasing
    h_taps: np.ndarray     # (S, taps) float32
    in_hw: tuple
    size: int
    taps: int              # T: the widest support, padded up to one of TAP_COUNTS
    pair_gap: int          # D ≥ w_start[2p+1] − w_start[2p], one of PAIR_GAPS
    rows_par: int          # band rows the width pass computes at once
    thread_pair: np.ndarray  # (THREADS,) int32: the output-column pair (2p, 2p+1) a
                             # thread computes in the width pass, −1 for none
    thread_row: np.ndarray   # (THREADS,) int32: its first band row, 0 … rows_par − 1
    thread_taps: np.ndarray  # (THREADS, 2T + D) float32: column 2p's T taps, then
                             # column 2p+1's over pixels w_start[2p] … + T + D − 1
    xf_stride: int         # 16-byte pixel slots per converted band row
    band_rows: int         # input rows per bulk copy
    ring_rows: int         # width-pass rows kept: band_rows + T − 1
    stage_bytes: int       # one stage of the copy ring
    smem_bytes: int
    blocks_per_sm: int

    @property
    def row_bytes(self) -> int:
        return self.in_hw[1] * 3


def _taps(m: np.ndarray, t: int):
    """(O, I) resampling matrix → (start (O,), taps (O, t)) holding every nonzero.

    Starts are clamped so start + t ≤ I; entries outside a row's support are zero."""
    n_out, n_in = m.shape
    first = np.zeros(n_out, np.int64)
    for o in range(n_out):
        nz = np.flatnonzero(m[o])
        first[o] = nz[0] if nz.size else 0
    start = np.minimum(first, n_in - t)
    taps = np.stack([m[o, s:s + t] for o, s in enumerate(start)]).astype(np.float32)
    return start.astype(np.int32), taps


def _support(m: np.ndarray) -> int:
    nz = [np.flatnonzero(row) for row in m]
    return max(int(z[-1] - z[0]) + 1 for z in nz if z.size)


def _smem(in_hw: tuple, out_cols: int, taps: int, band: int, xf_stride: int):
    """(stage bytes, shared-memory bytes) of one block: the mbarriers, STAGES stages of
    raw bytes (the band's 16-byte-aligned superset, up to 15 B before and after it, and
    a word of slack), the band converted to one 8-byte slot (bf16 r, g, b, 0) per pixel
    (xf_stride per row), the ring of band + T − 1 width-pass rows of out_cols f32
    (rounded up to 8), and the height taps and ring slots of the S output rows and the
    rows_done table."""
    stage = -(-(band * in_hw[1] * 3 + 32) // 16) * 16
    ring = (band + taps - 1) * (-(-out_cols // 8) * 8) * 4
    tables = (out_cols // 3 * (taps + 1) + in_hw[0] + 1) * 4
    return stage, _BARRIER_BYTES + STAGES * stage + band * xf_stride * 8 + ring + tables


def _assign(w_start: np.ndarray, size: int, rows_par: int, xf_stride: int):
    """Threads → (column pair, first band row) for the width pass, so that the 16 lanes
    of each half-warp start their 64-bit pixel loads in 16 different 8-byte bank pairs
    where the pairs allow it: then every load of the pass is one wavefront a half-warp.
    The items, sorted by bank pair, are dealt round-robin to the half-warps."""
    pairs = -(-size // 2)
    items = sorted(((r, p) for r in range(rows_par) for p in range(pairs)),
                   key=lambda it: (it[0] * xf_stride + int(w_start[2 * it[1]]))
                   % _BANK_GROUPS)
    groups = -(-len(items) // _BANK_GROUPS)
    pair = np.full(THREADS, -1, np.int32)
    row = np.zeros(THREADS, np.int32)
    for k, (r, p) in enumerate(items):
        g, lane = k % groups, k // groups
        pair[g * _BANK_GROUPS + lane], row[g * _BANK_GROUPS + lane] = p, r
    return pair, row


def _wavefronts(pair: np.ndarray, row: np.ndarray, w_start: np.ndarray,
                xf_stride: int) -> int:
    """Shared-memory wavefronts of one 64-bit load by every thread of the width pass:
    per half-warp, the most distinct 8-byte slots that fall in one bank pair."""
    total = 0
    for h in range(0, THREADS, _BANK_GROUPS):
        slots = {int(row[t]) * xf_stride + int(w_start[2 * pair[t]])
                 for t in range(h, h + _BANK_GROUPS) if pair[t] >= 0}
        per_bank = {}
        for u in slots:
            per_bank[u % _BANK_GROUPS] = per_bank.get(u % _BANK_GROUPS, 0) + 1
        total += max(per_bank.values(), default=0)
    return total


@functools.lru_cache(maxsize=16)
def tap_plan(in_hw: tuple, size: int, method: str = "bicubic") -> TapPlan:
    """Tap tables, the width pass's thread assignment and the kernel's band sizes for
    resize (and centre crop) of `in_hw` to size². Raises where no compiled tap count,
    pair gap or shared-memory size takes it."""
    wh, ww = resize_plan(tuple(in_hw), size, (size, size), method)
    need = max(_support(ww), _support(wh))
    fits = [t for t in TAP_COUNTS if t >= need]
    if not fits or min(in_hw) < fits[0]:
        raise ValueError(f"fused preprocess: {in_hw} → {size} needs {need} taps; the "
                         f"kernel takes up to {TAP_COUNTS[-1]} and inputs of at least "
                         "that many pixels")
    t = fits[0]
    pairs = -(-size // 2)
    if pairs > THREADS:
        raise ValueError(f"fused preprocess: output size {size} is above the kernel's "
                         f"{2 * THREADS}")
    w_start, w_taps = _taps(ww, t)
    h_start, h_taps = _taps(wh, t)
    gap = int((w_start[1::2] - w_start[:size - 1:2]).max(initial=0))
    gaps = [d for d in PAIR_GAPS if d >= gap]
    if not gaps:
        raise ValueError(f"fused preprocess: {in_hw} → {size} has output columns "
                         f"{gap} pixels apart, above {PAIR_GAPS[-1]}")
    d = gaps[0]
    rows_par = THREADS // pairs
    # the row stride (in 8-byte slots) whose assignment spreads the loads best
    xf_stride, pair, row = min(
        ((xs, *_assign(w_start, size, rows_par, xs))
         for xs in range(in_hw[1], in_hw[1] + _BANK_GROUPS)),
        key=lambda c: _wavefronts(c[1], c[2], w_start, c[0]))
    taps = np.zeros((THREADS, 2 * t + d), np.float32)
    for th, p in enumerate(pair):
        if p < 0:
            continue
        taps[th, :t] = w_taps[2 * p]
        if 2 * p + 1 < size:
            off = int(w_start[2 * p + 1] - w_start[2 * p])
            taps[th, t + off:2 * t + off] = w_taps[2 * p + 1]
    out_cols = size * 3
    sizes = {b: _smem(in_hw, out_cols, t, b, xf_stride) for b in _BAND_ROWS}
    band = blocks = None
    for k in range(BLOCKS_PER_SM, 0, -1):  # the most blocks per SM, then the widest band
        fit = [b for b in _BAND_ROWS if sizes[b][1] <= _SMEM_LIMIT
               and k * (sizes[b][1] + _BLOCK_RESERVED) <= _SM_SMEM]
        if fit:
            band, blocks = fit[0], k
            break
    if band is None:
        raise ValueError(f"fused preprocess: {in_hw} → {size} needs {sizes[1][1]} B of "
                         f"shared memory for one band row, above {_SMEM_LIMIT}")
    stage, smem = sizes[band]
    return TapPlan(w_start, w_taps, h_start, h_taps, tuple(in_hw), size, t, d, rows_par,
                   pair, row, taps, xf_stride, band, band + t - 1, stage, smem, blocks)


def work_items(plan: TapPlan, n: int, sms: int):
    """(chunks per image, output rows per chunk, grid) for n frames on `sms` SMs.

    A work item is one chunk of one image's output rows. The chunks per image follow
    the batch: as many as let n · chunks fill the blocks the card holds at once
    (blocks_per_sm per SM) in one wave, at least 1 and at most one output row each; the
    persistent grid is min(items, blocks the card holds)."""
    slots = sms * plan.blocks_per_sm
    chunks = min(plan.size, max(1, slots // n))
    rows = -(-plan.size // chunks)
    chunks = -(-plan.size // rows)  # no empty chunk
    return chunks, rows, min(n * chunks, slots)


def item_bands(plan: TapPlan, chunk_rows: int, chunk: int):
    """(output rows [r0, r1), input-row bands [(i0, i1), ...]) of one chunk, as the
    kernel walks them."""
    r0 = chunk * chunk_rows
    r1 = min(plan.size, r0 + chunk_rows)
    lo, hi = int(plan.h_start[r0]), int(plan.h_start[r1 - 1]) + plan.taps
    return (r0, r1), [(i, min(hi, i + plan.band_rows))
                      for i in range(lo, hi, plan.band_rows)]


def rows_done(plan: TapPlan) -> np.ndarray:
    """(H + 1,) int32: entry i counts the output rows r with h_start[r] + T ≤ i, those
    whose input rows all lie below row i (h_start is non-decreasing)."""
    return np.searchsorted(plan.h_start + plan.taps, np.arange(plan.in_hw[0] + 1),
                           side="right").astype(np.int32)


def band_copy(addr: int, nbytes: int, lo: int, hi: int):
    """The kernel's copy of a band at device address `addr` of frames that occupy
    [lo, hi): (pad, start, end). The band lands in its stage at byte `pad` = addr mod 16;
    the bulk copy moves device bytes [start, end): the band's 16-byte-aligned superset,
    clipped to the frames' aligned interior (start == end: no copy). The band's bytes
    outside it are read one by one."""
    start = max(addr // 16 * 16, -(-lo // 16) * 16)
    end = max(start, min(-(-(addr + nbytes) // 16) * 16, hi // 16 * 16))
    return addr % 16, start, end


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
    arrays = (plan.w_start, plan.h_start, (plan.h_start % plan.ring_rows).astype(np.int32),
              rows_done(plan), plan.h_taps, plan.thread_pair, plan.thread_row,
              plan.thread_taps)
    return plan, tuple(torch.as_tensor(a).to(device) for a in arrays)


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = Library("preprocess", {"ect_fused_preprocess": [_p] * 10 + [_i] * 16 + [_f] * 6 + [_i, _p]})


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
    chunks, chunk_rows, grid = work_items(plan, n, _sm_count(frames.device))
    inv, shift = _norm_consts(mean, std)
    LIB.ect_fused_preprocess(
        frames.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in tabs),
        n, h, w, size, plan.taps, plan.pair_gap, plan.rows_par, plan.xf_stride,
        plan.band_rows, plan.ring_rows, chunks, chunk_rows, grid, plan.stage_bytes,
        plan.smem_bytes, int(dtype == torch.bfloat16), *(float(v) for v in inv),
        *(float(v) for v in shift), *stream(frames))
    fused_preprocess.launches += 1
    return out


fused_preprocess.launches = 0
