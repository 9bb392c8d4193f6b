"""K2's plain version against the JAX package's two stem3 implementations on the scripted
THOR controller's flat frames.

The JAX int8 main path runs stem3 as an XLA bf16 conv, then `_requant` and
`_avg_pool_int8` (`embodied_clip_tpu/ops/quantize.py:488-493`). Its Pallas kernel
`stem3_requant_pool_int8` does not round the conv's output to bf16, and neither does the
port's K2. The JAX contract between kernel and graph (`tests/test_stem_kernel.py`: ≤1 s8
step on ≤0.5% of elements) is pinned on random data; flat frames are where a requant
tie flips whole regions at once.

Input: `clip_rn50`'s stem3 input for two 300×300 frames of the scripted controller (a
reset and one step), computed with the JAX package's quantized graph (preprocess, stem1
stride 2, stem2, as the default `int8_stem="off"` branch runs them). Three stems on it:
  (a) the JAX Pallas kernel in interpret mode;
  (b) the JAX XLA stem (`tests/test_stem_kernel.py:_xla_ref`);
  (c) the port's K2 plain version, with the same weights, bias and scale.
The test holds (c) no farther from (b) than (a) is, with a margin of a tenth of (a)'s
share. It also prints the distance of the same conv rounded to bf16 before its requant
(the port's plain int8 graph's stem) from (b). Run with -s to see the numbers.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax import lax

from embodied_clip_tpu.models.encoders import build_encoder
from embodied_clip_tpu.ops.pallas.stem_kernel import stem3_requant_pool_int8 as jax_stem
from embodied_clip_tpu.ops.quantize import _avg_pool_int8, _conv, _requant
from embodied_clip_tpu.parity import golden_frames

from embodied_clip_tpu_torch.envs.thor import THORObjectNavEnv
from embodied_clip_tpu_torch.ops.kernels.stem_kernel import (
    stem3_requant_pool_int8_reference,
)
from fake_thor import FakeController


def _scripted_frames() -> np.ndarray:
    """Two act-step frames (300×300) of the scripted controller: a reset and one
    step."""
    env = THORObjectNavEnv(["FloorPlan_Train1_1"], seed=0, controller_factory=FakeController)
    first = env.reset()["visual"]
    second = env.step(1)[0]["visual"]
    env.close()
    return np.stack([first, second])


def _stem3_input(qenc, frames):
    """stem2's f32 output, as the default branch of `quantized_trunk_apply` computes it
    (`fp_conv`: bf16 operands, bias, relu)."""
    q = qenc.qtrunk

    def fp_conv(name, t, stride=1):
        sub = q["fp"][name]["conv"]
        out = _conv(t.astype(jnp.bfloat16), jnp.asarray(sub["kernel"], jnp.bfloat16),
                    stride).astype(jnp.float32)
        return jax.nn.relu(out + jnp.asarray(sub["bias"], jnp.float32))

    x = qenc.preprocess(jnp.asarray(frames))
    return jax.jit(lambda t: fp_conv("stem2", fp_conv("stem1", t, 2)))(x)


def _conv3(x, kernel, pet=None):
    return lax.conv_general_dilated(
        x.astype(jnp.bfloat16), jnp.asarray(kernel, jnp.bfloat16), (1, 1),
        [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=pet)


def _xla_ref(x, kernel, bias, scale):
    out = _conv3(x, kernel).astype(jnp.float32) + jnp.asarray(bias, jnp.float32)
    return _avg_pool_int8(_requant(out, scale), 2)


def _bf16_rounded(x, kernel, bias, scale):
    out = _conv3(x, kernel, jnp.float32)
    out = out.astype(jnp.bfloat16).astype(jnp.float32) + jnp.asarray(bias, jnp.float32)
    return _avg_pool_int8(_requant(out, scale), 2)


def _steps(got, want):
    d = np.abs(np.asarray(got).astype(np.int32) - np.asarray(want).astype(np.int32))
    return int(d.max()), float((d != 0).mean())


def test_k2_plain_no_farther_from_xla_stem_than_jax_kernel():
    frames = _scripted_frames()
    assert frames.shape == (2, 300, 300, 3) and frames.dtype == np.uint8
    qenc = build_encoder("clip_rn50").fold_bn().quantize(golden_frames(32))
    x = _stem3_input(qenc, frames).astype(jnp.bfloat16)
    assert x.shape == (2, 112, 112, 32)
    sub = qenc.qtrunk["fp"]["stem3"]["conv"]
    kernel, bias = np.asarray(sub["kernel"], np.float32), np.asarray(sub["bias"], np.float32)
    scale = qenc.qtrunk["act_scales"]["stem.out"]

    xla = np.asarray(jax.jit(_xla_ref)(x, kernel, bias, scale))
    kern = np.asarray(jax_stem(x, kernel, bias, scale, interpret=True))
    rounded = np.asarray(jax.jit(_bf16_rounded)(x, kernel, bias, scale))
    plain = stem3_requant_pool_int8_reference(
        torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16),
        torch.from_numpy(kernel), torch.from_numpy(bias), float(scale)).numpy()
    assert plain.shape == xla.shape == (2, 56, 56, 64)

    a, c, r = _steps(kern, xla), _steps(plain, xla), _steps(rounded, xla)
    print(f"\nK2 on the scripted THOR frames (2, 112, 112, 32) -> (2, 56, 56, 64), (max "
          f"steps, share) from the JAX XLA stem: (a) JAX Pallas kernel {a[0]}, {a[1]:.3e}; "
          f"(c) port K2 plain version {c[0]}, {c[1]:.3e}; conv rounded to bf16 before "
          f"the requant {r[0]}, {r[1]:.3e}")
    assert a[0] <= 1 and a[1] <= 0.005, a  # the JAX package's own contract
    assert c[0] <= a[0] and c[1] <= 1.1 * a[1], (c, a)
