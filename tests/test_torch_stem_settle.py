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
from (b). Run with -s to see the numbers.

The JAX package's XLA graph leaves all three stem convs unrounded on the CPU: its
optimized HLO holds f32 convolutions of the bf16 operands there, with no bf16 convert
after them. The port's plain int8 graph runs its stem convs in that form
(`ops/quantize._fp_conv(..., f32_out=True)`): each stem conv's output equals JAX's in f32
up to the sum order, and the graph's s8 stem output equals the JAX XLA graph's on every
element of the settle frames.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from embodied_clip_tpu.models.encoders import build_encoder
from embodied_clip_tpu.ops.pallas.stem_kernel import stem3_requant_pool_int8 as jax_stem
from embodied_clip_tpu.ops.quantize import _avg_pool_int8, _conv, _requant
from embodied_clip_tpu.parity import golden_frames

from embodied_clip_tpu_torch.envs.thor import THORObjectNavEnv
from embodied_clip_tpu_torch.models.convert import from_flax_qtrunk
from embodied_clip_tpu_torch.ops import quantize as Q
from embodied_clip_tpu_torch.ops.int8 import avg_pool_int8
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


@pytest.fixture(scope="module")
def settle():
    """(the scripted frames, JAX's int8 `clip_rn50` calibrated on golden frames)."""
    frames = _scripted_frames()
    assert frames.shape == (2, 300, 300, 3) and frames.dtype == np.uint8
    return frames, build_encoder("clip_rn50").fold_bn().quantize(golden_frames(32))


def test_k2_plain_no_farther_from_xla_stem_than_jax_kernel(settle):
    frames, qenc = settle
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


def _jax_stem_s8(q, x):
    """The JAX XLA graph's s8 stem output: the default branch of `quantized_trunk_apply`
    (`embodied_clip_tpu/ops/quantize.py:413-430,487-493`) in one jit."""
    def fp_conv(name, t, stride=1, relu=True):
        sub = q["fp"][name]["conv"]
        out = _conv(t.astype(jnp.bfloat16), jnp.asarray(sub["kernel"], jnp.bfloat16),
                    stride).astype(jnp.float32)
        out = out + jnp.asarray(sub["bias"], jnp.float32)
        return jax.nn.relu(out) if relu else out

    def stem(x):
        t = fp_conv("stem2", fp_conv("stem1", x, 2))
        t = fp_conv("stem3", t, relu=False)
        return _avg_pool_int8(_requant(t, q["act_scales"]["stem.out"]), 2)

    return np.asarray(jax.jit(stem)(x))


def test_plain_int8_graph_stem_equals_jax_xla_stem(settle, monkeypatch):
    """The port's plain int8 graph (every kernel off), its s8 stem output captured at
    its first requant, against the JAX XLA graph's: 0 steps on every element."""
    frames, qenc = settle
    x = np.asarray(qenc.preprocess(jnp.asarray(frames)))
    q = from_flax_qtrunk(qenc.qtrunk)
    seen = []
    requant = Q.requant
    monkeypatch.setattr(Q, "requant", lambda *a: seen.append(requant(*a)) or seen[-1])
    Q.quantized_trunk_apply(q, torch.from_numpy(x), (3, 4, 6, 3),
                            out_dtype=torch.float32, **Q.KERNELS_OFF)
    got = avg_pool_int8(seen[0], 2).numpy()
    want = _jax_stem_s8(qenc.qtrunk, x)
    assert got.shape == want.shape == (2, 56, 56, 64)
    print(f"\nport plain int8 graph vs JAX XLA stem (max steps, share): "
          f"{_steps(got, want)}")
    assert _steps(got, want) == (0, 0.0)


@pytest.mark.parametrize("name,stride", [("stem1", 2), ("stem2", 1), ("stem3", 1)])
def test_repaired_stem_conv_equals_jax_f32(settle, name, stride):
    """Each stem conv of the port's plain int8 graph (`_fp_conv(..., f32_out=True)`, bias
    in, no relu) against JAX's (`_conv` of bf16 operands, `.astype(f32)`, bias) on the
    same bf16 input: equal in f32 up to the sum order (within 2⁻²⁰ of the output's
    largest magnitude), where the bf16-rounded conv is a bf16 step away."""
    frames, qenc = settle
    q = qenc.qtrunk
    x = qenc.preprocess(jnp.asarray(frames))
    chain = {"stem1": [], "stem2": [("stem1", 2)], "stem3": [("stem1", 2), ("stem2", 1)]}

    def fp_conv(n, t, s, relu):
        sub = q["fp"][n]["conv"]
        out = _conv(t.astype(jnp.bfloat16), jnp.asarray(sub["kernel"], jnp.bfloat16),
                    s).astype(jnp.float32) + jnp.asarray(sub["bias"], jnp.float32)
        return jax.nn.relu(out) if relu else out

    t = x
    for n, s in chain[name]:
        t = jax.jit(lambda t, n=n, s=s: fp_conv(n, t, s, True))(t)
    t = jnp.asarray(t).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(lambda t: fp_conv(name, t, stride, False))(t))
    qp = from_flax_qtrunk(q)
    tin = torch.from_numpy(np.asarray(t.astype(jnp.float32))).to(torch.bfloat16)
    got = Q._fp_conv(qp, name, tin, stride, relu=False, f32_out=True).numpy()
    rounded = Q._fp_conv(qp, name, tin, stride, relu=False).numpy()
    tol = 2.0 ** -20 * np.abs(want).max()
    err, err_rounded = np.abs(got - want).max(), np.abs(rounded - want).max()
    print(f"\n{name}: |f32 form - JAX| {err:.3e}, |bf16-rounded - JAX| {err_rounded:.3e}"
          f" (tolerance {tol:.3e})")
    assert err <= tol
    assert err_rounded > 100 * tol
