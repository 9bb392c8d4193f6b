"""PyTorch port of the preprocess path vs the JAX package, on the CPU.

The port's resize plan, its plain preprocess and the plain version of kernel K1 are
held to the JAX functions they port. K1 itself runs only on a GPU
(tests/test_torch_gpu.py); here its host-side tap tables and row tiling are checked,
and a numpy walk through the kernel's loops is held to the plain version.
"""

import dataclasses

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


@pytest.mark.parametrize("in_hw,size", [((300, 300), 224), ((160, 120), 224),
                                        ((300, 300), 128), ((480, 640), 384),
                                        ((1080, 1920), 224)])
def test_tap_tables_hold_the_dense_plan_and_tiles_cover_it(in_hw, size):
    wh, ww = resize.resize_plan(in_hw, size, (size, size))
    plan = K.tap_plan(in_hw, size)
    for start, taps, dense in ((plan.w_start, plan.w_taps, ww),
                               (plan.h_start, plan.h_taps, wh)):
        rebuilt = np.zeros_like(dense)
        for o, s in enumerate(start):
            assert 0 <= s and s + taps.shape[1] <= dense.shape[1]
            rebuilt[o, s:s + taps.shape[1]] = taps[o]
        np.testing.assert_array_equal(rebuilt, dense)
    th, rows = plan.h_taps.shape[1], plan.rows_per_tile
    assert len(plan.tile_in0) == -(-size // rows)
    for tile, (in0, span) in enumerate(zip(plan.tile_in0, plan.tile_span)):
        hs = plan.h_start[tile * rows:(tile + 1) * rows]
        assert in0 >= 0 and in0 + span <= in_hw[0]
        assert (hs >= in0).all() and (hs + th <= in0 + span).all()
    assert plan.smem_bytes == plan.max_span * (in_hw[1] + size) * 3 <= 232_448


def _walk_kernel(frames: np.ndarray, size: int, mean, std) -> np.ndarray:
    """numpy walk through csrc/preprocess.cu's three phases, one block at a time."""
    n, h, w, _ = frames.shape
    plan = K.tap_plan((h, w), size)
    inv, shift = K._norm_consts(mean, std)
    x = frames.reshape(n, h, w * 3)
    tw, th = plan.w_taps.shape[1], plan.h_taps.shape[1]
    cols = (plan.w_start[:, None] + np.arange(tw)) * 3          # (S, Tw) column bases
    out = np.empty((n, size, size * 3), np.float32)
    for img in range(n):
        for tile, (in0, span) in enumerate(zip(plan.tile_in0, plan.tile_span)):
            xs = x[img, in0:in0 + span].astype(np.float32)      # phase 1
            acc = np.zeros((span, size, 3), np.float32)        # phase 2
            for t in range(tw):
                for c in range(3):
                    acc[:, :, c] += plan.w_taps[:, t] * xs[:, cols[:, t] + c]
            a = np.clip(np.rint(acc), 0, 255).reshape(span, size * 3)
            r0 = tile * plan.rows_per_tile                     # phase 3
            r1 = min(r0 + plan.rows_per_tile, size)
            rows = plan.h_start[r0:r1] - in0
            b = np.zeros((r1 - r0, size * 3), np.float32)
            for t in range(th):
                b += plan.h_taps[r0:r1, t, None] * a[rows + t]
            b = np.clip(np.rint(b), 0, 255)
            out[img, r0:r1] = b * np.tile(inv, size) - np.tile(shift, size)
    return out.reshape(n, size, size, 3)


@pytest.mark.parametrize("in_hw", [(300, 300), (160, 120), (240, 427)])
def test_kernel_walk_matches_plain_version(in_hw):
    frames = np.random.RandomState(2).randint(0, 256, (2, *in_hw, 3), np.uint8)
    mean, std = constants.CLIP_MEAN, constants.CLIP_STD
    ref = K.fused_preprocess_reference(torch.from_numpy(frames), 224, mean, std,
                                       dtype=torch.float32).numpy()
    _assert_lsb_contract(_walk_kernel(frames, 224, mean, std), ref, std)


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


def test_preprocessor_kernel_flag_keeps_cpu_frames_on_the_plain_path():
    frames = torch.from_numpy(
        np.random.RandomState(4).randint(0, 256, (2, 300, 300, 3), np.uint8))
    plain = make_preprocessor("clip", 224, torch.bfloat16)
    flagged = dataclasses.replace(plain, use_kernel=True)
    before = K.fused_preprocess.launches
    assert torch.equal(flagged(frames), plain(frames))
    assert K.fused_preprocess.launches == before
