"""The plain versions of the port's int8 kernels K2–K5 vs the JAX package's Pallas
kernels, run in interpret mode on the CPU as the JAX package's own tests run them.

Same numpy-seeded operands for both, at the JAX tests' shapes and contracts:
  K2 stem3_requant_pool_int8  ≤1 s8 step on ≤0.5% of elements (tests/test_stem_kernel.py)
  K3 fused_stage1_int8        ≤1 step on ≤0.5%, RN50-shaped stage 1 at 14×14
                              (tests/test_bottleneck_kernel.py:177-178); at RN50 batch 8
                              and RN50x16 widths, the shortcut ≤1 step and the stage ≤2
                              steps on ≤0.5% (a flipped shortcut step's cascade), and no
                              farther from the JAX package's XLA stage-1 graph than the
                              JAX kernel is
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
from jax import lax

from embodied_clip_tpu.ops import quantize as jq
from embodied_clip_tpu.ops.pallas import bottleneck_kernel as jbk
from embodied_clip_tpu.ops.pallas.stem_kernel import stem3_requant_pool_int8 as jax_stem

from embodied_clip_tpu_torch.ops import quantize as Q
from embodied_clip_tpu_torch.ops.int8 import requant_signed
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


@pytest.mark.parametrize("cin,cout", [(8, 16), (32, 64), (48, 96)])
def test_stem3_weight_matrix_is_the_kernels_operand(cin, cout):
    """K2's weights as its kernel reads them: (Cout, Kp) K-major bf16, k = (ky·3 + kx)·Cp
    + c with Cin zero-padded to Cp = 16·⌈Cin/16⌉ and K to Kp = 64·⌈9·Cp/64⌉, so that the
    padded im2col rows of x times its transpose are the 3×3 'SAME' conv of bf16 operands."""
    rng = np.random.RandomState(11)
    kernel = torch.from_numpy(rng.randn(3, 3, cin, cout).astype(np.float32))
    x = torch.from_numpy(rng.randn(1, 5, 6, cin).astype(np.float32)).to(torch.bfloat16).float()
    w = SK.stem3_weight_matrix(kernel)
    cp = -(-cin // 16) * 16
    kp = -(-9 * cp // 64) * 64
    assert w.dtype == torch.bfloat16 and w.is_contiguous() and tuple(w.shape) == (cout, kp)
    assert not w[:, 9 * cp:].any()
    taps = w[:, :9 * cp].reshape(cout, 9, cp)
    assert not taps[..., cin:].any()
    xp = torch.nn.functional.pad(x, (0, cp - cin, 1, 1, 1, 1))
    cols = torch.cat([xp[:, ky:ky + 5, kx:kx + 6] for ky in range(3) for kx in range(3)], -1)
    got = cols.double() @ w[:, :9 * cp].double().t()
    want = torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2),
                                      kernel.to(torch.bfloat16).double().permute(3, 2, 0, 1),
                                      padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-9)


def test_stage1_shortcut_plain_version_rounds_the_exact_sum_once():
    """K3's shortcut in its plain version: the exact sum of the bf16 products rounded
    once to f32, whatever the summation order (here reversed k), then + bsc and the
    signed requant."""
    rng = np.random.RandomState(12)
    x8 = torch.from_numpy(C.s8(rng, (2, 3, 3, 64), 127))
    wsc = torch.from_numpy(rng.randn(64, 256).astype(np.float32) * 0.1).to(torch.bfloat16)
    bsc = torch.from_numpy(rng.randn(256).astype(np.float32) * 0.05)
    s_in, dsc = torch.tensor(2.0 / 127), torch.tensor(1.7 / 127)
    x0 = (x8.float() * s_in).to(torch.bfloat16).double()
    exact = torch.zeros((2, 3, 3, 256), dtype=torch.float64)
    for k in reversed(range(64)):
        exact += x0[..., k:k + 1] * wsc[k].double()
    want = requant_signed(exact.float() + bsc, dsc)
    assert torch.equal(BK._shortcut_reference(x8, wsc, bsc, s_in, dsc), want)


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


def _jax_kernel_shortcut(x8, wsc, bsc, s_in, dsc):
    """sc8 as the JAX kernel's shortcut computes it, one image (its grid step) at a time:
    a product of bf16 operands summed in f32 by jnp.dot, + bsc, the signed requant."""
    w = jnp.asarray(wsc.float().numpy()).astype(jnp.bfloat16)
    s = jnp.float32(s_in.item())
    sc = [np.asarray(jnp.dot((jnp.asarray(img.numpy()).astype(jnp.float32) * s)
                             .astype(jnp.bfloat16).reshape(-1, w.shape[0]), w,
                             preferred_element_type=jnp.float32))
          for img in x8]
    sc = torch.from_numpy(np.stack(sc)).reshape(*x8.shape[:-1], w.shape[1])
    return requant_signed(sc + bsc, dsc)


def _f32_shortcut(x8, wsc, bsc, s_in, dsc):
    """The shortcut with an f32 sum in torch's order (TF32 off): the other candidate for
    the plain version's sum."""
    x0 = (x8.float() * s_in).to(torch.bfloat16).float()
    return requant_signed(torch.matmul(x0, wsc.float()) + bsc, dsc)


def _jax_xla_stage1(qnp, x8):
    """Stage 1 as the JAX package's main path computes it on the TPU: the XLA graph of
    `quantized_trunk_apply` (s8 convs with s32 sums, the `_requant` epilogues, the bf16
    einsum shortcut and its signed s8 round trip), built from JAX ops as
    tests/test_bottleneck_kernel.py builds its reference."""
    q = _jq(qnp)
    a = q["act_scales"]

    def qconv(sub, t8, s):
        k = sub["kernel_q"]
        if k.shape[0] == 1:
            out = jnp.einsum("nhwc,cd->nhwd", t8, k[0, 0], preferred_element_type=jnp.int32)
        else:
            out = lax.conv_general_dilated(t8, k, (1, 1), [(1, 1), (1, 1)],
                                           dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                           preferred_element_type=jnp.int32)
        return out.astype(jnp.float32) * (s * sub["w_scale"]) + sub["bias"]

    def ref(t8):
        s_in = a["stem.out"]
        for i, nm in enumerate(["layer1_0", "layer1_1", "layer1_2"]):
            o = jax.nn.relu(qconv(q[f"{nm}/cb1"], t8, s_in))
            o = jax.nn.relu(qconv(q[f"{nm}/cb2"], jq._requant(o, a[f"{nm}/cb2.in"]),
                                  a[f"{nm}/cb2.in"]))
            o = qconv(q[f"{nm}/cb3"], jq._requant(o, a[f"{nm}/cb3.in"]), a[f"{nm}/cb3.in"])
            if i == 0:
                sub = q["fp"]["layer1_0/down"]["conv"]
                idt = jnp.einsum("nhwc,cd->nhwd",
                                 (t8.astype(jnp.float32) * s_in).astype(jnp.bfloat16),
                                 jnp.asarray(sub["kernel"], jnp.bfloat16)[0, 0],
                                 preferred_element_type=jnp.float32) + sub["bias"]
                ds = a["layer1_0/down.out"]
                idt = jq._requant_signed(idt, ds).astype(jnp.float32) * ds
            else:
                idt = t8.astype(jnp.float32) * s_in
            s_in = a[f"{nm}.out"]
            t8 = jq._requant(jax.nn.relu(o + idt), s_in)
        return t8

    return np.asarray(jax.jit(ref)(jnp.asarray(x8)))


# The stage-1 widths of RN50 (batch 8 at 56²) and RN50x16 (96 → 384), at sizes where one
# flipped shortcut step shows as 2 steps of K3's output. `kernel_share` is the JAX
# kernel's measured share of elements off the JAX XLA graph (CPU: 1.079e-03 and
# 2.439e-03), rounded up: the reference's own cascade, which bounds the port's.
@pytest.mark.parametrize("n,h,cin,cout,kernel_share", [(8, 56, 64, 256, 1.1e-3),
                                                       (2, 24, 96, 384, 2.5e-3)])
def test_stage1_plain_version_near_jax_kernel_at_full_width(monkeypatch, n, h, cin, cout,
                                                            kernel_share):
    """K3's plain version against the JAX package's two stage-1 implementations where the
    shortcut's cascade shows. The plain shortcut (the exact sum rounded once) is within 1
    step of the JAX kernel's on ≤1e-5 of elements. Over the stage, a flipped shortcut step
    carries through the later blocks to 2 steps. The JAX kernel (interpret mode) is itself
    2 steps from the JAX XLA stage-1 graph, the TPU main path's, on `kernel_share` of
    elements; the plain version is no farther from that graph (≤2 steps, ≤ the JAX
    kernel's measured share), so the 2 steps between the plain version and the JAX kernel
    are the reference's own cascade. Against the JAX kernel the plain version keeps the
    ≤0.5% share and is no farther than an f32 shortcut sum in torch's order. Run with -s
    to print the distances."""
    rng = np.random.RandomState(0)
    qnp = C.stage1_q(rng, cin=cin, cm=cin, cout=cout)
    x8 = C.s8(rng, (n, h, h, cin))
    want = np.asarray(jbk.fused_stage1_int8(jnp.asarray(x8),
                                            jax.jit(jq.stage1_int8_operands)(_jq(qnp)),
                                            interpret=True))
    xla = _jax_xla_stage1(qnp, x8)
    ops = Q.stage1_int8_operands(C.to_torch(qnp))
    xt, scl = torch.from_numpy(x8), ops["scl"]
    sc_args = (xt, ops["wsc"], ops["bsc"], scl[0], scl[10])
    sc_step, sc_share = C.step_diff(BK._shortcut_reference(*sc_args),
                                    _jax_kernel_shortcut(*sc_args))
    got = BK.fused_stage1_int8(xt, ops)
    kern_xla = C.step_diff(want, xla)
    plain_xla = C.step_diff(got, xla)
    dmax, share = C.step_diff(got, want)
    monkeypatch.setattr(BK, "_shortcut_reference", _f32_shortcut)
    dmax32, share32 = C.step_diff(BK.fused_stage1_int8(xt, ops), want)
    print(f"\nK3 {(n, h, h, cin)} -> {cout}, (max steps, share): JAX kernel vs JAX XLA "
          f"graph {kern_xla[0]}, {kern_xla[1]:.3e}; plain vs JAX XLA graph {plain_xla[0]}, "
          f"{plain_xla[1]:.3e}; plain vs JAX kernel {dmax}, {share:.3e} (f32 shortcut sum: "
          f"{dmax32}, {share32:.3e}); shortcut vs JAX kernel's {sc_step}, {sc_share:.3e}")
    assert kern_xla[0] <= 2 and kern_xla[1] <= kernel_share, kern_xla
    assert plain_xla[0] <= kern_xla[0] and plain_xla[1] <= kern_xla[1], (plain_xla, kern_xla)
    assert sc_step <= 1 and sc_share <= 1e-5, (sc_step, sc_share)
    assert dmax <= 2 and share <= 0.005 and share <= share32, (dmax, share, share32)


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


def _kmajor_pairs(builder):
    """(name, (K, N) or HWIO s8 kernel, its K-major copy) from one operand builder."""
    rng = np.random.RandomState(4)
    if builder == "stage1":
        ops = Q.stage1_int8_operands(C.to_torch(C.stage1_q(rng)))
        return [(k, ops[k], ops[k + "_t"]) for k in ops if k[0] == "k" and not k.endswith("_t")]
    q, names = C.identity_q(rng, 64, 16, 2)
    q = C.to_torch(q)
    if builder == "cb3_cb1":
        ops = Q.cb3_cb1_operands(q, names[0], names[1], torch.tensor(0.01))
        return [(k, ops[k], ops[k + "_t"]) for k in ("k3", "k1")]
    blocks, _ = Q.resblocks_int8_operands(q, names, torch.tensor(0.01), torch.tensor(0.02))
    return [(f"{i}/{k}", b[k], b[k + "_t"]) for i, b in enumerate(blocks)
            for k in ("k1", "k2", "k3")]


@pytest.mark.parametrize("builder", ["stage1", "cb3_cb1", "resblocks"])
def test_operand_builders_keep_kmajor_copies(builder):
    """Each s8 kernel has its K-major (N, K) copy beside it: the transpose of a 1×1
    kernel; for a 3×3 (3, 3, Cin, Cout) kernel (Cout, 9·Cin) with k = (ky·3 + kx)·Cin + c,
    the order of the 3×3 im2col, so that im2col rows times the copy is the s8 conv."""
    from embodied_clip_tpu_torch.ops.int8 import im2col3x3, qconv_acc

    pairs = _kmajor_pairs(builder)
    assert len(pairs) == {"stage1": 9, "cb3_cb1": 2, "resblocks": 6}[builder]
    for name, k, kt in pairs:
        assert kt.dtype == torch.int8 and kt.is_contiguous(), name
        if k.ndim == 2:
            assert torch.equal(kt, k.t()), name
            continue
        kh, kw, cin, cout = k.shape
        want = np.zeros((cout, 9 * cin), np.int8)
        for ky in range(3):
            for kx in range(3):
                want[:, (ky * 3 + kx) * cin:(ky * 3 + kx + 1) * cin] = k[ky, kx].numpy().T
        np.testing.assert_array_equal(kt.numpy(), want, name)
        x8 = torch.from_numpy(C.s8(np.random.RandomState(5), (1, 5, 6, cin)))
        cols = im2col3x3(x8, 1).reshape(-1, 9 * cin)
        assert torch.equal(torch._int_mm(cols, kt.t().contiguous()).reshape(1, 5, 6, cout),
                           qconv_acc(x8, k)), name
