"""The int8 trunk's stride blocks (block 0 of stages 2-4) and the int8 stems' s8 convs on
the port's own launches (`fused_stride_block_int8`, `conv3x3_int8` in
`embodied_clip_tpu_torch/ops/kernels/bottleneck_kernel.py`), against the JAX package on
the CPU, where the wrappers take their plain versions.

The JAX package has no TPU kernel for these: XLA emits its s8 convolutions. So:
  - the port's trunk with `kernel_stride_blocks` (every other kernel off) against JAX's
    `quantized_trunk_apply` with every Pallas flag off (the XLA graph), on the width-8
    trunk of `tests/test_torch_quantize.py` from the same stem output, at that file's
    tolerance for the plain graph: every s8 tensor requantized bit-exact but for ±1 step
    on ≤0.5% of elements (the bf16 shortcut's f32 sum order), cosine < 1e-5;
  - per block, the wrapper's s8 outputs equal to the plain graph's code as it stood
    before the stride blocks had a wrapper (`_block_before`, below) on every element, on
    path A (the whole block) and on path B ((o8, id8) for K4, with and without cb1's
    output given), in both requant forms;
  - on planted boundary operands (`torch_int8_cases.planted_stride_q`), the block under
    `recip` takes the reciprocal at all four requants, as the XLA graph's `_unscale`
    does: equal to JAX's block under ECT_RECIP_REQUANT=1 op by op, and apart from the
    division at each requant;
  - the int8-stem options through `conv3x3_int8` equal to the plain graph's s8 stem
    convs, in both requant forms;
  - `parity.stride_block_disagreement`, with which the card holds the block (cb3 on the
    kernel's own o8 and id8), agreeing here and naming a planted cb3 or o8 fault.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_clip_tpu.models.clip_resnet import ModifiedResNet as JaxResNet
from embodied_clip_tpu.ops import quantize as jq
from embodied_clip_tpu.ops.fold_bn import fold_conv_bn_tree

from embodied_clip_tpu_torch.models.convert import from_flax_qtrunk
from embodied_clip_tpu_torch.ops import int8 as I8
from embodied_clip_tpu_torch.ops import quantize as Q
from embodied_clip_tpu_torch.ops.int8 import avg_pool_int8, requant, requant_signed
from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
from embodied_clip_tpu_torch.parity import cosine_distance

import torch_int8_cases as C
from test_torch_quantize import _np, _perturb_bn, _run_jax_from_stem, _trunk_sd

STRIDE_BLOCKS = ("layer2_0", "layer3_0", "layer4_0")
ROUTE = {**Q.KERNELS_OFF, "kernel_stride_blocks": True}


@pytest.fixture(scope="module")
def carried():
    """`tests/test_torch_quantize.py`'s width-8 trunk (stage sizes (3, 2, 2, 2), random BN
    folded in): JAX's quantized trunk as numpy, the port's copy of it, the port's own
    quantized trunk (with the s8 stem entries of the int8-stem options) and the input."""
    stage_sizes = (3, 2, 2, 2)
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    module = JaxResNet(stage_sizes, 8)
    variables = _perturb_bn(_np(module.init(jax.random.PRNGKey(1), jnp.asarray(x))),
                            np.random.RandomState(2))
    folded = _np(jax.jit(fold_conv_bn_tree)(variables["params"], variables["batch_stats"]))
    qj = _np(jax.jit(lambda p, xx: jq.quantize_trunk(p, stage_sizes, xx))(folded, x))
    q_port = Q.quantize_trunk(_trunk_sd(folded), stage_sizes, torch.from_numpy(x))
    return stage_sizes, qj, from_flax_qtrunk(qj), q_port, x


def _spy(monkeypatch, name):
    """Records the (args, kwargs) of every call of BK.<name> and calls through."""
    calls, fn = [], getattr(BK, name)

    def spy(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)

    monkeypatch.setattr(BK, name, spy)
    return calls


def test_trunk_with_stride_blocks_matches_jax_xla_graph(carried, monkeypatch):
    stage_sizes, qj, q, _, x = carried
    seen = []
    record = lambda *a: seen.append(requant(*a)) or seen[-1]  # noqa: E731
    monkeypatch.setattr(Q, "requant", record)
    monkeypatch.setattr(BK, "requant", record)
    wrapper = BK.fused_stride_block_int8
    before = wrapper.launches
    calls = _spy(monkeypatch, "fused_stride_block_int8")
    got = Q.quantized_trunk_apply(q, torch.from_numpy(x), stage_sizes,
                                  out_dtype=torch.float32, **ROUTE)
    assert len(calls) == 3 and wrapper.launches == before  # the CPU takes the plain version
    t8 = avg_pool_int8(seen[0], 2)  # the graph's first requant is the stem's
    want, want_seen = _run_jax_from_stem(monkeypatch, qj, x, stage_sizes, t8)
    assert len(seen) - 1 == len(want_seen) == 3 * sum(stage_sizes) - 1
    diffs = [C.step_diff(g, w) for g, w in zip(seen[1:], want_seen)]
    assert diffs[0] == (0, 0.0)
    for dmax, share in diffs:
        assert dmax <= 1 and share <= 0.005, diffs
    assert cosine_distance(got, want) < 1e-5
    plain = Q.quantized_trunk_apply(q, torch.from_numpy(x), stage_sizes,
                                    out_dtype=torch.float32, **Q.KERNELS_OFF)
    assert torch.equal(got, plain)


def _block_before(q, name, t8, s_in, rq, cb3=True, q1=None):
    """The plain graph's stride block as `ops/quantize.quantized_trunk_apply` computed it
    inline before the wrapper existed: (o8, id8) for K4, or the block's s8 output."""
    a = q["act_scales"]
    s2, s3 = a[f"{name}/cb2.in"], a[f"{name}/cb3.in"]
    q18 = q1 if q1 is not None else requant(Q._qconv(q[f"{name}/cb1"], t8, s_in), s2, rq)
    o8 = avg_pool_int8(requant(Q._qconv(q[f"{name}/cb2"], q18, s2), s3, rq), 2)
    down = Q._fp_conv(q, f"{name}/down", avg_pool_int8(t8, 2).float() * s_in, relu=False)
    r_res = a[f"{name}/down.out"]
    id8 = requant_signed(down, r_res, rq)
    if not cb3:
        return o8, id8
    o = Q._qconv(q[f"{name}/cb3"], o8, s3)
    return requant(o + id8.float() * r_res, a[f"{name}.out"], rq)


def _block_inputs(carried, monkeypatch):
    """[(name, x8, s_in)] of the trunk's three stride blocks, as the route calls them."""
    stage_sizes, _, q, _, x = carried
    calls = _spy(monkeypatch, "fused_stride_block_int8")
    Q.quantized_trunk_apply(q, torch.from_numpy(x), stage_sizes, out_dtype=torch.float32,
                            **ROUTE)
    return [(name, args[0], args[1]["scl"][0]) for name, (args, _) in zip(STRIDE_BLOCKS, calls)]


@pytest.mark.parametrize("recip", [False, True])
def test_each_block_equals_the_plain_graph_before(carried, monkeypatch, recip):
    _, _, q, _, _ = carried
    for name, x8, s_in in _block_inputs(carried, monkeypatch):
        ops = Q.stride_block_int8_operands(q, name, s_in)
        got = BK.fused_stride_block_int8(x8, ops, recip=recip)
        want = _block_before(q, name, x8, s_in, recip)
        assert got.dtype == torch.int8 and got.shape == want.shape
        assert torch.equal(got, want), (name, C.step_diff(got, want))
        # Path B: (o8, id8) for K4, with cb1's output given (K4 made it) or not.
        o8, id8 = BK.fused_stride_block_int8(x8, ops, recip=recip, cb3=False)
        want_o8, want_id8 = _block_before(q, name, x8, s_in, recip, cb3=False)
        assert torch.equal(o8, want_o8) and torch.equal(id8, want_id8), name
        q1 = requant(Q._qconv(q[f"{name}/cb1"], x8, s_in), ops["scl"][1], recip)
        given = BK.fused_stride_block_int8(x8, ops, recip=recip, cb3=False, q1=q1)
        assert torch.equal(given[0], o8) and torch.equal(given[1], id8), name


# (cin, cm, cout): the width-16 trunk's stage-2 block, RN50's stage 2 and RN50x16's.
@pytest.mark.parametrize("cin,cm,cout", [(64, 32, 128), (256, 128, 512), (384, 192, 768)])
@pytest.mark.parametrize("recip", [False, True])
def test_block_at_the_model_widths_equals_the_plain_graph_before(cin, cm, cout, recip):
    rng = np.random.RandomState(cin)
    qnp, s_in = C.stride_q(rng, cin, cm, cout)
    q = C.to_torch(qnp)
    s_in = torch.tensor(s_in)
    x8 = torch.from_numpy(C.s8(rng, (2, 8, 8, cin)))
    ops = Q.stride_block_int8_operands(q, "layer2_0", s_in)
    assert ops["wsc_t"].shape == (cout, cin) and ops["k2_t"].shape == (cm, 9 * cm)
    got = BK.fused_stride_block_int8(x8, ops, recip=recip)
    assert torch.equal(got, _block_before(q, "layer2_0", x8, s_in, recip))
    conv_map = BK.fused_stride_block_int8(x8, ops, recip=recip, out_dtype=torch.float32)
    o8, id8 = _block_before(q, "layer2_0", x8, s_in, recip, cb3=False)
    want = torch.relu(Q._qconv(q["layer2_0/cb3"], o8, ops["scl"][2])
                      + id8.float() * ops["scl"][3])
    assert conv_map.dtype == torch.float32 and torch.equal(conv_map, want)


def _jax_block(qnp, name, x8, s_in):
    """JAX's stride block as its XLA graph computes it (`quantize.py:545-609`, its qconv
    and fp_conv at :417-444), op by op, jitted with the weights and scales as arguments
    (as constants XLA would turn each division into a product): the requants read
    ECT_RECIP_REQUANT. Returns (q1, o8, id8, the block output)."""

    def qconv(sub, t8, in_scale):
        k = sub["kernel_q"]
        if k.shape[0] == 1:
            out = jnp.einsum("nhwc,cd->nhwd", t8, k[0, 0], preferred_element_type=jnp.int32)
        else:
            out = jq._conv(t8, k, pet=jnp.int32)
        return out.astype(jnp.float32) * (in_scale * sub["w_scale"]) + sub["bias"]

    def block(q, t8, s_in):
        a = q["act_scales"]
        s2, s3 = a[f"{name}/cb2.in"], a[f"{name}/cb3.in"]
        q18 = jq._requant(qconv(q[f"{name}/cb1"], t8, s_in), s2)
        o8 = jq._avg_pool_int8(jq._requant(qconv(q[f"{name}/cb2"], q18, s2), s3), 2)
        down = q["fp"][f"{name}/down"]["conv"]
        k = down["kernel"].astype(jnp.bfloat16)
        idsrc = jq._avg_pool_int8(t8, 2).astype(jnp.float32) * s_in
        sc = jnp.einsum("nhwc,cd->nhwd", idsrc.astype(jnp.bfloat16), k[0, 0],
                        preferred_element_type=jnp.float32) + down["bias"]
        r_res = a[f"{name}/down.out"]
        id8 = jq._requant_signed(sc, r_res)
        out = jq._requant(qconv(q[f"{name}/cb3"], o8, s3) + id8.astype(jnp.float32) * r_res,
                          a[f"{name}.out"])
        return q18, o8, id8, out

    q = jax.tree.map(jnp.asarray, qnp)
    return [np.asarray(t) for t in jax.jit(block)(q, jnp.asarray(x8), jnp.float32(s_in))]


@pytest.mark.parametrize("cin,cm,cout", [(32, 16, 64), (64, 32, 128)])
def test_block_recip_follows_the_xla_graph_on_planted_boundaries(monkeypatch, cin, cm, cout):
    """Planted operands put every requant's quotient at n + 0.5, where the division and
    the reciprocal part: the block under `recip` equals JAX's XLA block under
    ECT_RECIP_REQUANT=1 at cb1, cb2 (o8), the shortcut (id8) and cb3 (the output), takes
    the reciprocal at exactly those four requants, and the division moves each."""
    qnp, s_in = C.planted_stride_q(cin, cm, cout)
    q = C.to_torch(qnp)
    x8 = C.s8(np.random.RandomState(3), (2, 8, 8, cin), hi=12)
    monkeypatch.setenv("ECT_RECIP_REQUANT", "1")
    want_q1, want_o8, want_id8, want_out = _jax_block(qnp, "layer2_0", x8, s_in)
    monkeypatch.setenv("ECT_RECIP_REQUANT", "0")
    div_q1, div_o8, div_id8, div_out = _jax_block(qnp, "layer2_0", x8, s_in)
    ops = Q.stride_block_int8_operands(q, "layer2_0", torch.tensor(s_in))
    xt = torch.from_numpy(x8)

    forms, unscale = [], I8.unscale
    monkeypatch.setattr(I8, "unscale", lambda v, s, recip=False: forms.append(recip)
                        or unscale(v, s, recip))
    got = BK.fused_stride_block_int8(xt, ops, recip=True)
    assert forms == [True] * 4, forms  # cb1, cb2, the shortcut, cb3
    o8, id8 = BK.fused_stride_block_int8(xt, ops, recip=True, cb3=False)
    q1 = requant(BK._affine(BK._pw(xt, ops["k1"]), ops["s1"], ops["b1"]), ops["scl"][1], True)
    np.testing.assert_array_equal(q1.numpy(), want_q1)
    for port, xla, div in ((o8, want_o8, div_o8), (id8, want_id8, div_id8),
                           (got, want_out, div_out)):
        np.testing.assert_array_equal(port.numpy(), xla)
        assert (xla != div).any()  # the planted quotients part the two forms
    np.testing.assert_array_equal(BK.fused_stride_block_int8(xt, ops).numpy(), div_out)
    assert (want_q1 != div_q1).any()


@pytest.mark.parametrize("int8_stem", ["stem3", "full"])
@pytest.mark.parametrize("recip", [False, True])
def test_int8_stems_take_conv3x3_int8(carried, monkeypatch, int8_stem, recip):
    """The int8-stem options under `kernel_stride_blocks`: their s8 stem convs go through
    `conv3x3_int8` (stem2 and stem3 under "full", stem3 under "stem3"; the pool with
    stem3), whose output equals the plain graph's on every element."""
    stage_sizes, _, _, q, x = carried
    calls = _spy(monkeypatch, "conv3x3_int8")
    kw = dict(out_dtype=torch.float32, int8_stem=int8_stem, recip_requant=recip)
    got = Q.quantized_trunk_apply(q, torch.from_numpy(x), stage_sizes, **ROUTE, **kw)
    assert [c[1]["pool"] for c in calls] == ([False, True] if int8_stem == "full" else [True])
    plain = Q.quantized_trunk_apply(q, torch.from_numpy(x), stage_sizes, **Q.KERNELS_OFF, **kw)
    assert torch.equal(got, plain)
    a = q["act_scales"]
    scales = {"stem2": (a["stem1.out"], a["stem2.out"]), "stem3": (a["stem2.out"], a["stem.out"])}
    names = ["stem2", "stem3"] if int8_stem == "full" else ["stem3"]
    for name, ((x8, ops), ckw) in zip(names, calls):
        s_in, s_out = scales[name]
        want = requant(Q._qconv(q[name], x8, s_in), s_out, recip)
        if ckw["pool"]:
            want = avg_pool_int8(want, 2)
        assert torch.equal(BK.conv3x3_int8(x8, ops, **ckw), want), name


def test_the_route_is_on_in_the_kernel_paths():
    assert Q.PATH_A["kernel_stride_blocks"] and Q.PATH_B["kernel_stride_blocks"]
    assert not Q.KERNELS_OFF["kernel_stride_blocks"]


def test_path_b_feeds_k4_from_the_block(carried, monkeypatch):
    """Path B on the plain versions: each stride block stops before cb3 and K4 takes it
    (with the next block's cb1); blocks 0 of stages 3 and 4 take their cb1 from K4.
    Equal to path A."""
    stage_sizes, _, q, _, x = carried
    monkeypatch.setattr(Q, "PALLAS_RESBLOCKS_MIN_CM", 1)
    calls = _spy(monkeypatch, "fused_stride_block_int8")
    b = Q.quantized_trunk_apply(q, torch.from_numpy(x), stage_sizes, out_dtype=torch.float32,
                                **Q.PATH_B)
    assert [kw["cb3"] for _, kw in calls] == [False] * 3
    assert [kw["q1"] is None for _, kw in calls] == [True, False, False]
    a = Q.quantized_trunk_apply(q, torch.from_numpy(x), stage_sizes, out_dtype=torch.float32,
                                **Q.PATH_A)
    assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [{}, {"recip": True}, {"out_dtype": torch.bfloat16},
                                {"cb3": False}])
def test_stride_block_disagreement_holds_cb3_on_the_kernels_own_inputs(monkeypatch, kw):
    """`parity.stride_block_disagreement`, the card's check of the block: on the CPU the
    wrapper is its plain version, so o8, id8 and cb3 agree; a fault in cb3 alone (one
    element one step off in the block output) or in o8 alone is named as such."""
    from embodied_clip_tpu_torch.parity import stride_block_disagreement

    rng = np.random.RandomState(21)
    qnp, s_in = C.stride_q(rng, 64, 32, 128)
    ops = Q.stride_block_int8_operands(C.to_torch(qnp), "layer2_0", torch.tensor(s_in))
    x8 = torch.from_numpy(C.s8(rng, (2, 8, 8, 64)))
    r = stride_block_disagreement(x8, ops, **kw)
    assert r["o8_equal"] and r["id8_step"] == 0 and r["id8_share"] == 0.0
    assert r["cb3_equal"] is (None if kw.get("cb3") is False else True)
    if kw.get("cb3") is False:
        assert all(torch.equal(g, w) for g, w in zip(r["out"], r["plain"]))
        return
    assert torch.equal(r["out"], r["plain"])
    wrapper = BK.fused_stride_block_int8

    def faulty(*args, where, **k):
        out = wrapper(*args, **k)
        t = out[0] if isinstance(out, tuple) else out
        if (where == "o8") == isinstance(out, tuple):
            t = t.clone()
            t.view(-1)[5] += 1 if t.view(-1)[5] < 1 else -1
        return (t, out[1]) if isinstance(out, tuple) else t

    monkeypatch.setattr(BK, "fused_stride_block_int8",
                        lambda *a, **k: faulty(*a, where="cb3", **k))
    r = stride_block_disagreement(x8, ops, **kw)
    assert r["o8_equal"] and r["cb3_equal"] is False
    monkeypatch.setattr(BK, "fused_stride_block_int8",
                        lambda *a, **k: faulty(*a, where="o8", **k))
    assert stride_block_disagreement(x8, ops, **kw)["o8_equal"] is False
