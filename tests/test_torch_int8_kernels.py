"""The plain versions of the port's int8 kernels K2–K5 vs the JAX package's Pallas
kernels, run in interpret mode on the CPU as the JAX package's own tests run them.

Same numpy-seeded operands for both, at the JAX tests' shapes and contracts:
  K2 stem3_requant_pool_int8  ≤1 s8 step on ≤0.5% of elements (tests/test_stem_kernel.py)
  K3 fused_stage1_int8        ≤1 step on ≤0.5%, RN50-shaped stage 1 at 14×14
                              (tests/test_bottleneck_kernel.py:177-178)
  K4 fused_cb3_cb1_int8       bit-exact, K = C ≤ 1024 and > 1024 (tests/test_quantize.py:87)
  K5 fused_resblocks_int8     bit-exact, s8 and bf16 outputs
                              (tests/test_bottleneck_kernel.py:257,265)
On the CPU each port wrapper takes its plain version, which is what runs here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_clip_tpu.ops import quantize as jq
from embodied_clip_tpu.ops.pallas import bottleneck_kernel as jbk
from embodied_clip_tpu.ops.pallas.stem_kernel import stem3_requant_pool_int8 as jax_stem

from embodied_clip_tpu_torch.ops import quantize as Q
from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
from embodied_clip_tpu_torch.ops.kernels import stem_kernel as SK

import torch_int8_cases as C


def _jq(qnp):
    return jax.tree.map(jnp.asarray, qnp)


@pytest.mark.parametrize("n,h,cin,cout", [(2, 16, 32, 64), (1, 12, 8, 16)])
def test_stem3_plain_version_matches_jax_kernel(n, h, cin, cout):
    rng = np.random.RandomState(0)
    x = np.abs(rng.randn(n, h, h, cin)).astype(np.float32) * 0.5
    kernel = rng.randn(3, 3, cin, cout).astype(np.float32) * 0.1
    bias = rng.randn(cout).astype(np.float32) * 0.05
    scale = np.float32(2.3 / 127)
    want = np.asarray(jax_stem(jnp.asarray(x, jnp.bfloat16), kernel, bias, scale,
                               interpret=True))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = SK.stem3_requant_pool_int8(xt, torch.from_numpy(kernel), torch.from_numpy(bias),
                                     torch.tensor(scale))
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    dmax, share = C.step_diff(got, want)
    assert dmax <= 1 and share <= 0.005, (dmax, share)


def test_stage1_plain_version_matches_jax_kernel():
    rng = np.random.RandomState(0)
    qnp = C.stage1_q(rng)
    x8 = C.s8(rng, (2, 14, 14, 64))
    want = np.asarray(jbk.fused_stage1_int8(jnp.asarray(x8),
                                            jax.jit(jq.stage1_int8_operands)(_jq(qnp)),
                                            interpret=True))
    got = BK.fused_stage1_int8(torch.from_numpy(x8),
                               Q.stage1_int8_operands(C.to_torch(qnp)))
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape == (2, 14, 14, 256)
    dmax, share = C.step_diff(got, want)
    assert dmax <= 1 and share <= 0.005, (dmax, share)


@pytest.mark.parametrize("cin,cm,n,h", [(256, 64, 2, 7), (1280, 64, 2, 4)])
def test_cb3_cb1_plain_version_matches_jax_kernel(cin, cm, n, h):
    rng = np.random.RandomState(1)
    qnp, names = C.identity_q(rng, cin, cm, 2)
    r_res = np.float32(1.9 / 127)
    x8, res8 = C.s8(rng, (n, h, h, cm)), C.s8(rng, (n, h, h, cin))
    ops = jax.jit(lambda q: jq.cb3_cb1_operands(q, names[0], names[1], r_res))(_jq(qnp))
    want = jbk.fused_cb3_cb1_int8(jnp.asarray(x8), jnp.asarray(res8), ops, interpret=True)
    got = BK.fused_cb3_cb1_int8(
        torch.from_numpy(x8), torch.from_numpy(res8),
        Q.cb3_cb1_operands(C.to_torch(qnp), names[0], names[1], torch.tensor(r_res)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("out_dtype", ["int8", "bfloat16"])
def test_resblocks_plain_version_matches_jax_kernel(out_dtype):
    rng = np.random.RandomState(2)
    qnp, names = C.identity_q(rng, 32, 16, 3)
    s_in = np.float32(1.8 / 127)
    s_next = (np.float32(qnp["act_scales"][f"{names[-1]}.out"]) if out_dtype == "int8"
              else np.float32(1.0))
    x8 = C.s8(rng, (2, 6, 6, 32))
    ops, scl = jax.jit(lambda q: jq.resblocks_int8_operands(q, names, s_in, s_next))(_jq(qnp))
    want = np.asarray(jbk.fused_resblocks_int8(jnp.asarray(x8), ops, scl,
                                               out_dtype=getattr(jnp, out_dtype),
                                               interpret=True), np.float32)
    tops, tscl = Q.resblocks_int8_operands(C.to_torch(qnp), names, torch.tensor(s_in),
                                           torch.tensor(s_next))
    got = BK.fused_resblocks_int8(torch.from_numpy(x8), tops, tscl,
                                  out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_operand_scale_products_match_jax():
    """in_scale · w_scale products (the epilogue scales) are bit-equal to JAX's."""
    rng = np.random.RandomState(3)
    qnp = C.stage1_q(rng)
    want = jax.jit(jq.stage1_int8_operands)(_jq(qnp))
    got = Q.stage1_int8_operands(C.to_torch(qnp))
    for k in want:
        if k[0] in "sb":
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]).reshape(-1), k)
    np.testing.assert_array_equal(got["wsc"].float().numpy(), np.asarray(want["wsc"], np.float32))
    for k in ("k1a", "k2b", "k3c"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k], np.float32))
