"""The plain versions of the port's bf16 kernels K6 (`fused_bottleneck`) and K7
(`fused_stage1`) vs the JAX package's Pallas kernels in interpret mode, on the CPU.

Same numpy-seeded operands for both, at the JAX tests' shapes
(tests/test_bottleneck_kernel.py:25-80) and at an RN50-width shape (C 256, Cm 64, 8×8):
  f32   atol = rtol = 1e-5, the JAX kernels' own contract;
  bf16  within one bf16 step: rtol 2⁻⁷ with atol 2⁻⁷ × the output's RMS. Both round h1,
        h2 and each block output at the same points and only the f32 sum order differs;
        a rounding it flips moves a value by a step of the operand it came from, which
        is absolute where the residual add cancels.
On the CPU each port wrapper takes its plain version, which is what runs here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embodied_clip_tpu.ops.pallas import bottleneck_kernel as jbk

from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK

BF16_STEP = 2.0 ** -7  # one bf16 step, relative (8 significant bits)


def _block(rng, c_in, cm, c_out):
    return {"w1": rng.randn(c_in, cm).astype(np.float32) * 0.1,
            "b1": rng.randn(cm).astype(np.float32) * 0.1,
            "w2": rng.randn(3, 3, cm, cm).astype(np.float32) * 0.1,
            "b2": rng.randn(cm).astype(np.float32) * 0.1,
            "w3": rng.randn(cm, c_out).astype(np.float32) * 0.1,
            "b3": rng.randn(c_out).astype(np.float32) * 0.1}


def _to(tree, lib, dtype):
    """numpy block(s) → jnp or torch; weights in `dtype`, biases f32."""
    def cast(k, a):
        dt = dtype if k[0] == "w" else "float32"
        return (jnp.asarray(a, getattr(jnp, dt)) if lib == "jax"
                else torch.from_numpy(a).to(getattr(torch, dt)))
    return {k: cast(k, a) for k, a in tree.items()}


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        rms = float(np.sqrt(np.mean(want ** 2)))
        np.testing.assert_allclose(got, want, rtol=BF16_STEP, atol=BF16_STEP * rms)


# (n, h, w, c, cm): the JAX test's shape, and RN50's stage-1 identity width.
@pytest.mark.parametrize("n,h,w,c,cm", [(4, 10, 10, 32, 8), (2, 8, 8, 256, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_bottleneck_plain_version_matches_jax_kernel(n, h, w, c, cm, dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(n, h, w, c).astype(np.float32) * 0.5
    blk = _block(rng, c, cm, c)
    jb = _to(blk, "jax", dtype)
    want = jbk.fused_bottleneck(jnp.asarray(x, getattr(jnp, dtype)), jb["w1"], jb["b1"],
                                jb["w2"], jb["b2"], jb["w3"], jb["b3"], interpret=True)
    tb = _to(blk, "torch", dtype)
    before = BK.fused_bottleneck.launches
    got = BK.fused_bottleneck(torch.from_numpy(x).to(getattr(torch, dtype)), tb["w1"],
                              tb["b1"], tb["w2"], tb["b2"], tb["w3"], tb["b3"])
    assert BK.fused_bottleneck.launches == before  # the CPU takes the plain version
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


# (n, h, w, cin, cm, cout): the JAX test's shape, and RN50's stage 1 at 8×8.
@pytest.mark.parametrize("n,h,w,cin,cm,cout", [(2, 8, 8, 16, 8, 32), (2, 8, 8, 64, 64, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_stage1_plain_version_matches_jax_kernel(n, h, w, cin, cm, cout, dtype):
    rng = np.random.RandomState(1)
    blocks = [_block(rng, cin, cm, cout), _block(rng, cout, cm, cout),
              _block(rng, cout, cm, cout)]
    sc = {"ws": rng.randn(cin, cout).astype(np.float32) * 0.1,
          "bs": rng.randn(cout).astype(np.float32) * 0.1}
    x = rng.randn(n, h, w, cin).astype(np.float32) * 0.5
    jsc = _to({"w": sc["ws"], "b": sc["bs"]}, "jax", dtype)
    want = jbk.fused_stage1(jnp.asarray(x, getattr(jnp, dtype)),
                            [_to(b, "jax", dtype) for b in blocks], (jsc["w"], jsc["b"]),
                            interpret=True)
    tsc = _to({"w": sc["ws"], "b": sc["bs"]}, "torch", dtype)
    before = BK.fused_stage1.launches
    got = BK.fused_stage1(torch.from_numpy(x).to(getattr(torch, dtype)),
                          [_to(b, "torch", dtype) for b in blocks], (tsc["w"], tsc["b"]))
    assert BK.fused_stage1.launches == before
    assert tuple(got.shape) == (n, h, w, cout) and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)
