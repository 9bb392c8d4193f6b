"""The stride blocks' conv shortcut as the port splits it (`ops/kernels/bottleneck_kernel.py`):
(f') the pool + scale of the block input, converted once to the shortcut's bf16 A operand
with its rows' norms, and (e) the product, whose near-ties are flagged with a margin per
column built once with the operands (`shortcut_margins`). On the CPU the wrappers take
their plain versions, so these tests hold:

  - (f')'s plain version against the JAX graph's x0 (`quantize.py:572-574`:
    `_avg_pool_int8(t8, 2)` as f32 × s_in, cast to bf16, as `fp_conv` takes it), on every
    element at RN50's three stride-block widths, and its row norms against a float64 sum
    rounded up;
  - the margin: a numpy model of the tensor cores' f32 sum (Fasi, Higham, Mikaitis and
    Pranesh, "Numerical behavior of NVIDIA tensor cores", PeerJ Comput. Sci. 7:e330,
    2021: each addition of a block of b exact products to the running sum aligns every
    addend to the largest exponent, truncates it to 24 bits there, and truncates the sum
    to f32), summed in groups of `SHORTCUT_GROUP_K` k and promoted with IEEE f32 adds as
    the kernel does, stays within ||x0 row||₂ · margin factor · dsc of the exact sum
    rounded once (`_shortcut_reference`'s), for b in {4, 8, 16, 32}, on random rows and on
    rows built to hurt it (mixed exponents, cancellation, truncated tails);
  - the operand builder's margins.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embodied_clip_tpu.ops import quantize as jq

from embodied_clip_tpu_torch.ops import quantize as Q
from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK

import torch_int8_cases as C

# RN50's stride blocks: (Cin, input side at batch 128), cut to a few images.
WIDTHS = [(256, 56), (512, 28), (1024, 14)]


def _f32_up(x: np.ndarray) -> np.ndarray:
    f = x.astype(np.float32)
    return np.where(f.astype(np.float64) < x, np.nextafter(f, np.float32(np.inf)), f)


@pytest.mark.parametrize("cin,side", WIDTHS)
@pytest.mark.parametrize("s_in", [2.0 / 127, 0.0137, 3.1e-3])
def test_pool_scale_plain_version_equals_the_jax_graphs_x0(cin, side, s_in):
    rng = np.random.RandomState(cin + side)
    x8 = rng.randint(-128, 128, (2, side, side, cin)).astype(np.int8)
    s = np.float32(s_in)
    want = (jq._avg_pool_int8(jnp.asarray(x8), 2).astype(jnp.float32) * s).astype(jnp.bfloat16)
    want = np.asarray(want.astype(jnp.float32))
    x0, rnorm = BK.pool2_scale_reference(torch.from_numpy(x8), torch.tensor(s))
    assert x0.dtype == torch.bfloat16 and x0.shape == (2, side // 2, side // 2, cin)
    np.testing.assert_array_equal(x0.float().numpy(), want)
    # The norms: the f64 sum of the squares rounded up to f32, never below the norm.
    norm = np.sqrt(np.square(want.astype(np.float64)).sum(-1))
    assert rnorm.dtype == torch.float32 and rnorm.shape == x0.shape[:-1]
    np.testing.assert_array_equal(rnorm.numpy(), _f32_up(norm))
    assert (rnorm.double().numpy() >= norm).all()


def test_pool_scale_norm_sum_is_exact_in_any_order():
    """The squares of x0's values span fewer than 53 bits, so their f64 sum does not
    depend on the order: forwards, backwards and pairwise give one value."""
    rng = np.random.RandomState(5)
    x8 = rng.randint(-128, 128, (1, 2, 2, 2048)).astype(np.int8)
    x8[..., ::7] = 1  # the smallest |x0| beside the largest
    x0, _ = BK.pool2_scale_reference(torch.from_numpy(x8), torch.tensor(np.float32(0.0137)))
    sq = x0.double().square().reshape(-1).numpy()
    fwd = 0.0
    for v in sq:
        fwd += v
    bwd = 0.0
    for v in sq[::-1]:
        bwd += v
    assert fwd == bwd == float(sq.sum())


def _trunc_f32(x: np.ndarray) -> np.ndarray:
    """x (f64) truncated toward zero to f32."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _tensor_core_sum(prods: np.ndarray, b: int, group: int) -> np.ndarray:
    """The kernel's sum of each row of exact products (P, K) f64: groups of `group` k,
    each summed from zero on the modelled tensor cores in blocks of b (align to the
    largest addend's exponent, truncate every addend to 24 bits there, sum, truncate to
    f32), added to the running f32 sum with IEEE adds in k order."""
    p, k = prods.shape
    acc = np.zeros(p, np.float32)
    for g0 in range(0, k, group):
        s = np.zeros(p)
        for j in range(g0, min(g0 + group, k), b):
            add = np.concatenate([s[:, None], prods[:, j:j + b]], axis=1)
            top = np.abs(add).max(1)
            _, e = np.frexp(np.where(top > 0, top, 1.0))  # top = m · 2^e, m in [0.5, 1)
            ulp = np.ldexp(1.0, e - 24)[:, None]  # 24 bits below the largest's leading bit
            s = _trunc_f32((np.trunc(add / ulp) * ulp).sum(1)).astype(np.float64)
        acc = acc + s.astype(np.float32)  # f32 + f32: the IEEE promotion add
    return acc


def _case(kind: str, rng, k: int, rows: int, cols: int):
    """(x8 (rows, 2, 2, k) s8 whose pool is the row, s_in, wsc (k, cols) bf16)."""
    s_in = np.float32(0.0137)
    if kind == "random":
        xp = rng.randint(-128, 128, (rows, k))
        w = rng.randn(k, cols) * 2.0 ** -rng.randint(1, 13, (k, cols))
    elif kind == "mixed_exponents":
        # |x0| from s_in to 127·s_in beside weights 12 binades apart, large ones first.
        xp = np.where(rng.rand(rows, k) < 0.5, 1, 127) * rng.choice([-1, 1], (rows, k))
        w = rng.randn(k, cols) * 2.0 ** -np.sort(rng.randint(0, 13, (k, cols)), axis=0)
    elif kind == "cancellation":
        # Pairs of nearly equal products of opposite sign: E a sliver of S.
        xp = np.repeat(rng.randint(100, 128, (rows, k // 2)), 2, axis=1)
        half = rng.randn(k // 2, cols)
        w = np.repeat(half, 2, axis=0) * np.tile([1.0, -1.0], k // 2)[:, None]
        w = w * (1 + 2.0 ** -7 * rng.randint(-2, 3, (k, 1)))
    else:  # "truncated_tails": one large product a block, the rest just under its 24th bit
        xp = np.full((rows, k), 127)
        w = np.full((k, cols), 2.0 ** -25) * (1 - 2.0 ** -8)
        w[::4] = 1.0
        w = w * rng.choice([1.0, 1.0 + 2.0 ** -7], (k, cols))
    x8 = np.repeat(np.repeat(xp.astype(np.int8)[:, None, None, :], 2, 1), 2, 2)
    return x8, s_in, torch.from_numpy(w).to(torch.bfloat16)


@pytest.mark.parametrize("b", [4, 8, 16, 32])
@pytest.mark.parametrize("kind", ["random", "mixed_exponents", "cancellation",
                                  "truncated_tails"])
@pytest.mark.parametrize("k", [256, 1024])
def test_tensor_core_sum_stays_within_the_margin(b, kind, k):
    rng = np.random.RandomState(k + b)
    rows, cols = 8, 32
    x8, s_in, wsc = _case(kind, rng, k, rows, cols)
    dsc = torch.tensor(np.float32(0.021))
    x0, rnorm = BK.pool2_scale_reference(torch.from_numpy(x8), torch.tensor(s_in))
    x0, rnorm = x0.reshape(rows, k), rnorm.reshape(rows)
    colm = BK.shortcut_margins(wsc, dsc)
    x0d, wd = x0.double().numpy(), wsc.double().numpy()
    prods = (x0d[:, None, :] * wd.T[None, :, :]).reshape(rows * cols, k)  # exact in f64
    acc = _tensor_core_sum(prods, b, BK.SHORTCUT_GROUP_K).reshape(rows, cols)
    exact = (x0.double() @ wsc.double()).float().numpy()  # _shortcut_reference's sum
    err = np.abs(acc.astype(np.float64) - exact)
    margin = rnorm.double().numpy()[:, None] * colm.double().numpy()[None, :] * float(dsc)
    assert (err <= margin).all(), float((err / margin).max())
    # The model sums with error (it is not the exact sum), and the margin is not slack by
    # orders of magnitude: on these rows the error reaches a measurable share of it.
    assert err.max() > 0 and (err / margin).max() > 1e-6


def test_margins_are_built_with_the_operands():
    rng = np.random.RandomState(3)
    qnp, s_in = C.stride_q(rng, 256, 128, 512)
    ops = Q.stride_block_int8_operands(C.to_torch(qnp), "layer2_0", torch.tensor(s_in))
    dsc = ops["scl"][3]
    want = BK.shortcut_margins(ops["wsc"], dsc)
    assert ops["wsc_m"].dtype == torch.float32 and torch.equal(ops["wsc_m"], want)
    # (128 + G) · 2^-24 · ||wsc[:, c]||₂ / dsc for G = 256 / 32 groups, rounded up and
    # widened by 2^-20: never below the margin, above it by under 2^-19.
    norm = ops["wsc"].double().square().sum(0).sqrt()
    plain = (128 + 8) * 2.0 ** -24 * norm / dsc.double()
    ratio = want.double() / plain
    assert (ratio >= 1 + 2.0 ** -20).all() and (ratio <= 1 + 2.0 ** -19).all()
    with pytest.raises(ValueError, match="wsc_m"):
        BK._shortcut_margins({k: v for k, v in ops.items() if k != "wsc_m"})
