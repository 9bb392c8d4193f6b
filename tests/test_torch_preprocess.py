"""PyTorch port of the preprocess path vs the JAX package, on the CPU.

The port's resize plan, its plain preprocess and the plain version of kernel K1 are
held to the JAX functions they port. K1 itself runs only on a GPU
(tests/test_torch_gpu.py); here its host-side plan is checked (tap tables, work items,
band copies) and a numpy walk through the kernel's phases is held to the plain version.
"""


import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embodied_clip_tpu import constants
from embodied_clip_tpu.ops import resize as jax_resize
from embodied_clip_tpu.ops.pallas.preprocess_kernel import fused_preprocess_pallas
from embodied_clip_tpu.ops.preprocess import make_preprocessor as jax_make_preprocessor

from embodied_clip_tpu_torch.ops import resize
from embodied_clip_tpu_torch.ops.kernels import preprocess_kernel as K
from embodied_clip_tpu_torch.ops.preprocess import make_preprocessor

PLANS = [((300, 300), 224, (224, 224), "bicubic"), ((256, 341), 224, (224, 224), "bicubic"),
         ((160, 120), 224, (224, 224), "bicubic"), ((480, 360), 384, (384, 384), "bicubic"),
         ((100, 100), (224, 224), None, "bicubic"), ((300, 300), 224, (224, 224), "bilinear")]


def _assert_lsb_contract(got, ref, std):
    """The JAX contract for the fused preprocess (tests/test_pallas_preprocess.py):
    rounding in another domain or order flips isolated pixels by one uint8 LSB at .5
    ties, so ≤1.5 LSB everywhere and <1e-3 of pixels beyond 0.5 LSB."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    lsb = 1.0 / 255.0 / min(std)
    err = np.abs(got - ref)
    assert err.max() <= 1.5 * lsb, err.max() / lsb
    assert (err > 0.5 * lsb).mean() < 1e-3


@pytest.mark.parametrize("in_hw,size,crop,method", PLANS)
def test_resize_plan_matches_jax_bitwise(in_hw, size, crop, method):
    wh, ww = resize.resize_plan(in_hw, size, crop, method)
    jwh, jww = jax_resize.resize_plan(in_hw, size, crop, method)
    np.testing.assert_array_equal(wh, jwh)
    np.testing.assert_array_equal(ww, jww)


@pytest.mark.parametrize("kind", ["clip", "imagenet"])
@pytest.mark.parametrize("layout", ["nhwc", "flat", "hwc", "float"])
def test_plain_preprocess_matches_jax(kind, layout):
    frames = np.random.RandomState(0).randint(0, 256, (2, 300, 280, 3), np.uint8)
    if layout == "flat":
        frames = frames.reshape(2, 300, 280 * 3)
    elif layout == "hwc":
        frames = frames[0]
    elif layout == "float":
        frames = frames.astype(np.float32) / 255.0
    ref = np.asarray(jax_make_preprocessor(kind, 224, jnp.float32)(jnp.asarray(frames)))
    pre = make_preprocessor(kind, 224, torch.float32)
    got = pre(torch.from_numpy(frames)).numpy()
    _assert_lsb_contract(got, ref, pre.std)


@pytest.mark.parametrize("n,in_hw", [(2, (300, 300)), (1, (160, 120))])
def test_kernel_plain_version_matches_pallas_interpret(n, in_hw):
    frames = np.random.RandomState(1).randint(0, 256, (n, *in_hw, 3), np.uint8)
    mean, std = constants.CLIP_MEAN, constants.CLIP_STD
    ref = fused_preprocess_pallas(jnp.asarray(frames), 224, mean, std,
                                  dtype=jnp.float32, interpret=True)
    got = K.fused_preprocess_reference(torch.from_numpy(frames), 224, mean, std,
                                       dtype=torch.float32)
    assert tuple(got.shape) == (n, 224, 224, 3)
    _assert_lsb_contract(got.numpy(), np.asarray(ref), std)


def _check_band_copies(plan, n, data_offset, chunks, chunk_rows):
    """Every band copy of n frames stored from byte `data_offset` stays inside them, and
    its bulk part is 16-byte aligned at both ends in device and shared memory."""
    h, w3 = plan.in_hw[0], plan.row_bytes
    lo, hi = data_offset, data_offset + n * h * w3
    for img in range(n):
        for chunk in range(chunks):
            _, bands = K.item_bands(plan, chunk_rows, chunk)
            for i0, i1 in bands:
                addr, nbytes = data_offset + (img * h + i0) * w3, (i1 - i0) * w3
                pad, a0, a1 = K.band_copy(addr, nbytes, lo, hi)
                assert lo <= addr and addr + nbytes <= hi
                assert a0 % 16 == 0 and a1 % 16 == 0 and lo <= a0 <= a1 <= hi
                assert addr - 16 < a0 <= max(addr, a1) and a1 < addr + nbytes + 16
                # only a frame tensor's first and last bands read bytes one by one
                assert a0 <= addr or addr < lo + 16
                assert a1 >= addr + nbytes or addr + nbytes > hi - 16
                assert (a0 - addr + pad) % 16 == 0  # shared-memory destination
                assert a1 - addr + pad <= plan.stage_bytes and pad + nbytes + 4 <= plan.stage_bytes


@pytest.mark.parametrize("in_hw,size", [((300, 300), 224), ((160, 120), 224),
                                        ((300, 300), 128), ((480, 640), 384),
                                        ((1080, 1920), 224)])
def test_tap_tables_hold_the_dense_plan_and_tiles_cover_it(in_hw, size):
    """The tap tables rebuild the dense resize matrices; the kernel's work items (chunks
    of output rows) cover every output row exactly once, their bands cover the input
    rows those rows read, and the band and ring sizes add up to the shared memory."""
    wh, ww = resize.resize_plan(in_hw, size, (size, size))
    plan = K.tap_plan(in_hw, size)
    t = plan.taps
    assert t in K.TAP_COUNTS and plan.w_taps.shape[1] == plan.h_taps.shape[1] == t
    for start, taps, dense in ((plan.w_start, plan.w_taps, ww),
                               (plan.h_start, plan.h_taps, wh)):
        rebuilt = np.zeros_like(dense)
        for o, s in enumerate(start):
            assert 0 <= s and s + t <= dense.shape[1]
            rebuilt[o, s:s + t] = taps[o]
        np.testing.assert_array_equal(rebuilt, dense)
    assert (np.diff(plan.h_start) >= 0).all()  # the height pass walks down the rows
    done = K.rows_done(plan)
    assert all(done[i] == (plan.h_start + t <= i).sum() for i in range(in_hw[0] + 1))
    assert plan.ring_rows == plan.band_rows + t - 1
    assert K._smem(in_hw, size * 3, t, plan.band_rows,
                   plan.xf_stride)[1] == plan.smem_bytes <= 232_448
    assert in_hw[1] <= plan.xf_stride < in_hw[1] + 16
    # the width pass: every (column pair, band row offset) once, and each thread's taps
    # the dense rows of its two columns over its window
    d, pairs = plan.pair_gap, -(-size // 2)
    got = sorted((int(r), int(p)) for p, r in zip(plan.thread_pair, plan.thread_row)
                 if p >= 0)
    assert got == [(r, p) for r in range(plan.rows_par) for p in range(pairs)]
    for th, p in enumerate(plan.thread_pair):
        if p < 0:
            continue
        x0 = int(plan.w_start[2 * p])
        for col, row in ((2 * p, plan.thread_taps[th, :t]),
                         (2 * p + 1, plan.thread_taps[th, t:])):
            window = np.zeros(ww.shape[1] + t + d)
            window[:ww.shape[1]] = ww[col] if col < size else 0
            np.testing.assert_array_equal(row, window[x0:x0 + len(row)])
    for n, sms in ((1, 132), (5, 132), (128, 132), (3, 1)):
        chunks, chunk_rows, grid = K.work_items(plan, n, sms)
        assert grid <= n * chunks
        rows = []
        for chunk in range(chunks):
            (r0, r1), bands = K.item_bands(plan, chunk_rows, chunk)
            assert r0 < r1
            rows += range(r0, r1)
            assert bands[0][0] == plan.h_start[r0]
            assert bands[-1][1] == plan.h_start[r1 - 1] + t <= in_hw[0]
            assert all(b[1] == c[0] for b, c in zip(bands, bands[1:]))
            assert all(0 < i1 - i0 <= plan.band_rows for i0, i1 in bands)
        assert sorted(rows) == list(range(size))
        _check_band_copies(plan, n, 0, chunks, chunk_rows)


@pytest.mark.parametrize("data_offset", [0, 1, 3, 13])
@pytest.mark.parametrize("in_hw", [(300, 300), (301, 299), (480, 640), (1080, 1920)])
def test_band_copies_stay_inside_the_frames_and_meet_the_16_byte_rule(in_hw, data_offset):
    """Row widths 900, 897, 1,920 and 5,760 B, frames starting at any byte."""
    plan = K.tap_plan(in_hw, 224)
    for n in (1, 3):
        _check_band_copies(plan, n, data_offset, *K.work_items(plan, n, 132)[:2])


@pytest.mark.parametrize("n", [1, 128])
def test_work_items_fill_the_card_at_batch_1_and_128(n):
    """At the main path's plan the chunks per image follow the batch: n · chunks items
    occupy every SM of an H100 (132) in one wave of the blocks it holds."""
    plan = K.tap_plan((300, 300), 224)
    sms = 132
    chunks, chunk_rows, grid = K.work_items(plan, n, sms)
    slots = sms * plan.blocks_per_sm
    assert plan.blocks_per_sm == 2
    assert sms <= n * chunks <= slots and grid == n * chunks
    assert (chunks, chunk_rows) == {1: (224, 1), 128: (2, 112)}[n]


def _walk_kernel(frames: np.ndarray, size: int, mean, std, data_offset: int = 13,
                 sms: int = 132) -> np.ndarray:
    """numpy walk through csrc/preprocess.cu's phases, block by block and band by band,
    with the frames stored from byte `data_offset` of device memory: (1) the band's bulk
    copy of its aligned superset (clipped to the frames' aligned interior) into the stage,
    the band at offset pad, its bytes outside the copy read byte by byte; (2) the
    conversion to one (r, g, b, 0) slot per pixel (exact as bf16), rows xf_stride slots
    apart, in shared memory zeroed at the start; (3) the width pass,
    thread by thread: its column pair's window of T + D slots, column 2p's taps on the
    first T, into the ring, input row i in slot i mod ring_rows; (4) the height pass of
    every output row whose rows are in the ring, normalised. The ring remembers which
    row each slot holds, and a read of a slot that holds another row fails."""
    n, h, w, _ = frames.shape
    plan = K.tap_plan((h, w), size)
    inv, shift = K._norm_consts(mean, std)
    mem = np.zeros(data_offset + frames.size, np.uint8)
    mem[data_offset:] = frames.ravel()
    w3, s3, t, d = w * 3, size * 3, plan.taps, plan.pair_gap
    ring_rows, xs = plan.ring_rows, plan.xf_stride
    active = plan.thread_pair >= 0
    pair, wrow = plan.thread_pair[active], plan.thread_row[active]
    taps = plan.thread_taps[active]
    window = plan.w_start[2 * pair][:, None] + np.arange(t + d)     # (threads, T + D)
    cols = 6 * pair[:, None] + np.arange(6)                          # ring floats
    keep = cols < s3
    norm_inv, norm_shift = np.tile(inv, size), np.tile(shift, size)
    done = K.rows_done(plan)
    chunks, chunk_rows, grid = K.work_items(plan, n, sms)
    out = np.full((n, size, s3), np.nan, np.float32)
    for block in range(grid):
        # zeroed once: the converted band (+ the window's overrun) and the ring
        xf = np.zeros((plan.band_rows * xs + t + d, 4), np.float32)
        ring = np.zeros((ring_rows, -(-s3 // 8) * 8), np.float32)
        held = np.full(ring_rows, -1)
        for item in range(block, n * chunks, grid):
            img, chunk = divmod(item, chunks)
            (r0, r1), bands = K.item_bands(plan, chunk_rows, chunk)
            out_next = r0
            for i0, i1 in bands:
                addr, nbytes = data_offset + (img * h + i0) * w3, (i1 - i0) * w3
                pad, a0, a1 = K.band_copy(addr, nbytes, data_offset, mem.size)
                stage = np.zeros(plan.stage_bytes, np.uint8)    # 1: the copy
                stage[a0 - addr + pad:a1 - addr + pad] = mem[a0:a1]
                idx = addr + np.arange(nbytes)
                ragged = (idx < a0) | (idx >= a1)
                stage[pad + np.flatnonzero(ragged)] = mem[idx[ragged]]
                pix = stage[pad:pad + nbytes].reshape(i1 - i0, w, 3)  # 2: convert
                big = np.arange((i1 - i0) * w)  # the kernel's row of pixel P, in f32
                rows_f32 = ((big.astype(np.float32) + np.float32(0.5))
                            * (np.float32(1) / np.float32(w))).astype(np.int64)
                assert (rows_f32 == big // w).all()
                for ii in range(i1 - i0):
                    xf[ii * xs:ii * xs + w, :3] = pix[ii]
                for i in range(i0, i1):                          # 3: width pass
                    mine = (i - i0) % plan.rows_par == wrow
                    win = xf[(i - i0) * xs + window[mine]]       # (threads, T + D, 4)
                    a = np.zeros((mine.sum(), 6), np.float32)
                    for j in range(t + d):
                        if j < t:
                            a[:, :3] = a[:, :3] + taps[mine, j:j + 1] * win[:, j, :3]
                        a[:, 3:] = a[:, 3:] + taps[mine, t + j:t + j + 1] * win[:, j, :3]
                    ring[i % ring_rows, cols[mine][keep[mine]]] = np.clip(
                        np.rint(a), 0, 255)[keep[mine]]
                    held[i % ring_rows] = i
                out_end = min(r1, max(out_next, done[i1]))       # 4: height pass
                for r in range(out_next, out_end):
                    rows = plan.h_start[r] + np.arange(t)
                    assert (held[rows % ring_rows] == rows).all()
                    b = np.zeros(s3, np.float32)
                    for k in range(t):
                        b = b + plan.h_taps[r, k] * ring[rows[k] % ring_rows, :s3]
                    out[img, r] = np.clip(np.rint(b), 0, 255) * norm_inv - norm_shift
                out_next = out_end
            assert out_next == r1
    return out.reshape(n, size, size, 3)


@pytest.mark.parametrize("in_hw", [(300, 300), (160, 120), (240, 427)])
def test_kernel_walk_matches_plain_version(in_hw):
    """At batch 2 on 132 SMs (short chunks, each one band) and on one SM (one chunk per
    image: the ring carried down 224 output rows)."""
    frames = np.random.RandomState(2).randint(0, 256, (2, *in_hw, 3), np.uint8)
    mean, std = constants.CLIP_MEAN, constants.CLIP_STD
    ref = K.fused_preprocess_reference(torch.from_numpy(frames), 224, mean, std,
                                       dtype=torch.float32).numpy()
    for sms in (132, 1):
        _assert_lsb_contract(_walk_kernel(frames, 224, mean, std, sms=sms), ref, std)


def test_kernel_rounding_and_staging_are_exact():
    """Two exact steps of csrc/preprocess.cu, in f32 on the CPU: q() rounds by
    (v + 1.5·2²³) − 1.5·2²³, which is rint (half to even) for |v| < 2²², over and past
    the range a pass's sums take, ties included; and every byte 0 … 255 survives the
    staged band's bf16 exactly."""
    big = np.float32(12582912.0)
    v = np.concatenate([np.linspace(-1024, 1024, 1_000_001, dtype=np.float32),
                        np.arange(-1024, 1025, dtype=np.float32) + np.float32(0.5)])
    v = np.concatenate([v, np.nextafter(v, np.float32(0)), np.nextafter(v, np.float32(1e9))])
    np.testing.assert_array_equal((v + big) - big, np.rint(v))
    byte = torch.arange(256, dtype=torch.float32)
    assert torch.equal(byte.to(torch.bfloat16).float(), byte)


def test_wrapper_takes_plain_version_for_cpu_tensors_only():
    frames = torch.from_numpy(
        np.random.RandomState(3).randint(0, 256, (2, 300, 300, 3), np.uint8))
    mean, std = constants.CLIP_MEAN, constants.CLIP_STD
    before = K.fused_preprocess.launches
    f32 = K.fused_preprocess(frames, 224, mean, std, dtype=torch.float32)
    bf16 = K.fused_preprocess(frames, 224, mean, std, dtype=torch.bfloat16)
    assert K.fused_preprocess.launches == before  # no kernel ran
    torch.testing.assert_close(
        f32, K.fused_preprocess_reference(frames, 224, mean, std, dtype=torch.float32),
        rtol=0, atol=0)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))
    with pytest.raises(ValueError, match="no kernel for device"):
        K.fused_preprocess(frames.to("meta"), 224, mean, std)


def test_preprocessor_kernel_flag_keeps_cpu_frames_on_the_plain_path(monkeypatch):
    """A bf16 preprocessor hands only CUDA frames to K1: CPU frames that need a resize
    take the plain f32 path, cast once at its end, and never reach K1's wrapper."""
    calls = []
    monkeypatch.setattr(K, "fused_preprocess", lambda *args, **kw: calls.append(args))
    frames = torch.from_numpy(
        np.random.RandomState(4).randint(0, 256, (2, 300, 300, 3), np.uint8))
    bf16 = make_preprocessor("clip", 224, torch.bfloat16)
    f32 = make_preprocessor("clip", 224, torch.float32)
    assert torch.equal(bf16(frames), f32(frames).to(torch.bfloat16))
    assert not calls
