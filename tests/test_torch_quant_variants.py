"""The JAX package's int8 graph options in the port, against the JAX package on the CPU.

Each option is a trace-time environment variable in the JAX package and a keyword in
the port:
  ECT_RECIP_REQUANT=1   recip_requant=True   every requant a multiply by 1 / scale
  ECT_INT8_STEM         int8_stem            "stem3" | "full": s8 stem convs
  ECT_INT4_STAGE1       int4_stage1          1 | 2: stage 1 on a 4-bit grid
  ECT_VIT_QUANT_ATTN=0  quant_attn=False     the ViT's attention denses in bf16
  ECT_VIT_CONV_OUT=1    (none)               an XLA emitter choice, bit-equal: no keyword
`clip_rn_tiny` at 160×160 (the JAX tests' `encs` setup) with the JAX `qtrunk` carried
across by `from_flax_qtrunk`: each option's conv map within cosine 1e-5 of JAX's jitted
graph under the same variable (the tolerance of
`test_torch_quantize.py::test_plain_graph_matches_jax_from_the_stem_on`). The plain
K2-K5 in the reciprocal form against the JAX Pallas kernels in interpret mode under
ECT_RECIP_REQUANT=1 (K4/K5 bit-equal, K2/K3 within ≤1 s8 step on ≤0.5%). The
reciprocal form on the ViT and torchvision graphs; guards that each option changes
what it should and no more; the trees `from_flax_*` carries; `resize_bicubic`.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_clip_tpu.models.encoders import build_encoder as jax_build_encoder
from embodied_clip_tpu.models.resnet import ResNet as JaxTVResNet
from embodied_clip_tpu.ops import quantize as jq
from embodied_clip_tpu.ops import resize as jax_resize
from embodied_clip_tpu.ops.fold_bn import fold_conv_bn_tree
from embodied_clip_tpu.ops.pallas import bottleneck_kernel as jbk
from embodied_clip_tpu.ops.pallas.stem_kernel import stem3_requant_pool_int8 as jax_stem
from embodied_clip_tpu.ops.quantize_vit import quantize_vit as jax_quantize_vit
from embodied_clip_tpu.ops.quantize_vit import quantized_vit_apply as jax_qvit_apply

from embodied_clip_tpu_torch.models.convert import (
    from_flax_qtrunk,
    from_flax_qvit,
    from_flax_variables,
)
from embodied_clip_tpu_torch.models.clip_vit import CLIP_VIT_CONFIGS
from embodied_clip_tpu_torch.models.encoders import build_encoder
from embodied_clip_tpu_torch.models.resnet import RESNET_CONFIGS
from embodied_clip_tpu_torch.ops import int8 as I8
from embodied_clip_tpu_torch.ops import quantize as Q
from embodied_clip_tpu_torch.ops import resize_bicubic
from embodied_clip_tpu_torch.ops.int8 import requant, requant_s4, requant_signed, requant_u4
from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
from embodied_clip_tpu_torch.ops.kernels import stem_kernel as SK
from embodied_clip_tpu_torch.ops.quantize_vit import ATTN_DENSES, quantized_vit_apply
from embodied_clip_tpu_torch.parity import cosine_distance, golden_frames

import torch_clip_cases as CC
import torch_int8_cases as C

# option name → (the port's keywords, the JAX package's environment, its keywords)
TRUNK_OPTIONS = {
    "recip": (dict(recip_requant=True), {"ECT_RECIP_REQUANT": "1"}, {}),
    "stem3": (dict(int8_stem="stem3"), {}, dict(int8_stem="stem3")),
    "full": (dict(int8_stem="full"), {}, dict(int8_stem="full")),
    "int4_1": (dict(int4_stage1=1), {}, dict(int4_stage1=1)),
    "int4_2": (dict(int4_stage1=2), {}, dict(int4_stage1=2)),
    "recip_full_int4": (dict(recip_requant=True, int8_stem="full", int4_stage1=1),
                        {"ECT_RECIP_REQUANT": "1"}, dict(int8_stem="full", int4_stage1=1)),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@contextlib.contextmanager
def requant_forms():
    """Records the form of every requant the port makes inside (True: reciprocal)."""
    forms, unscale = [], I8.unscale

    def spy(x, scale, recip=False):
        forms.append(recip)
        return unscale(x, scale, recip)

    I8.unscale = spy
    try:
        yield forms
    finally:
        I8.unscale = unscale


def _one_form(fn, recip):
    """fn()'s result, checked to requant in one form only: the reciprocal where asked,
    the division where not."""
    with requant_forms() as forms:
        out = fn()
    assert forms and all(f == recip for f in forms), (recip, forms)
    return out


def _jax_env(monkeypatch, env):
    for k in ("ECT_RECIP_REQUANT", "ECT_VIT_QUANT_ATTN", "ECT_VIT_CONV_OUT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.fixture(scope="module")
def tiny():
    """JAX's int8 `clip_rn_tiny` (f32, folded, calibrated on 2 of 4 frames at 160×160),
    its qtrunk as numpy and carried across, and the preprocessed frames."""
    frames = np.random.RandomState(0).randint(0, 256, (4, 160, 160, 3), np.uint8)
    enc = jax_build_encoder("clip_rn_tiny", dtype=jnp.float32).fold_bn()
    qenc = enc.quantize(frames[:2])
    qj = _np(qenc.qtrunk)
    x = np.asarray(qenc.preprocess(jnp.asarray(frames)))
    return qenc.stage_sizes, qj, from_flax_qtrunk(qj), x, frames


def _jax_trunk(monkeypatch, qj, x, stage_sizes, env, **kw):
    """JAX's int8 trunk, jitted as its encoders run it, under `env`."""
    _jax_env(monkeypatch, env)
    fn = jax.jit(lambda q, xx: jq.quantized_trunk_apply(q, xx, stage_sizes,
                                                        out_dtype=jnp.float32, **kw))
    return np.asarray(fn(jax.tree.map(jnp.asarray, qj), jnp.asarray(x)))


def _port_trunk(q, x, stage_sizes, **kw):
    return Q.quantized_trunk_apply(q, torch.from_numpy(x), stage_sizes,
                                   out_dtype=torch.float32, **Q.KERNELS_OFF, **kw).numpy()


@pytest.mark.parametrize("option", list(TRUNK_OPTIONS))
def test_trunk_option_matches_jax(tiny, monkeypatch, option):
    stage_sizes, qj, q, x, _ = tiny
    port_kw, env, jax_kw = TRUNK_OPTIONS[option]
    want = _jax_trunk(monkeypatch, qj, x, stage_sizes, env, **jax_kw)
    got = _port_trunk(q, x, stage_sizes, **port_kw)
    assert got.shape == want.shape and np.isfinite(got).all()
    d = cosine_distance(got, want)
    assert d < 1e-5, (option, d)


def test_options_change_the_graph(tiny):
    """The stem and int4 options change the conv map (JAX's `changed > 0`). The
    reciprocal form parts from the division only on near-ties (none may fall in a tiny
    trunk; the planted ones are in `test_recip_requant_matches_jax_on_near_ties`): every
    requant of the graph takes it, and it moves each s8 tensor by at most one step, on
    few elements."""
    stage_sizes, _, q, x, _ = tiny
    base = _one_form(lambda: _port_trunk(q, x, stage_sizes), False)
    for option, (kw, _, _) in TRUNK_OPTIONS.items():
        out = _one_form(lambda: _port_trunk(q, x, stage_sizes, **kw),
                        kw.get("recip_requant", False))
        if option != "recip":
            assert np.abs(out - base).max() > 0.0, option

    seen = {False: [], True: []}
    for recip in (False, True):
        orig = Q.requant

        def record(*a, recip=recip):
            seen[recip].append(orig(*a))
            return seen[recip][-1]

        Q.requant = record
        try:
            _port_trunk(q, x, stage_sizes, recip_requant=recip)
        finally:
            Q.requant = orig
    assert len(seen[False]) == len(seen[True]) > 0
    diffs = [C.step_diff(a, b) for a, b in zip(seen[False], seen[True])]
    assert all(d <= 1 and s <= 0.005 for d, s in diffs), diffs


def test_options_are_checked(tiny):
    stage_sizes, _, q, x, _ = tiny
    with pytest.raises(ValueError, match="int8_stem"):
        _port_trunk(q, x, stage_sizes, int8_stem="stem2")
    with pytest.raises(ValueError, match="int4_stage1"):
        _port_trunk(q, x, stage_sizes, int4_stage1=4)


def test_int4_is_off_under_the_kernels(tiny):
    """int4_stage1 runs on the plain graph only: under a kernel switch it is off, as in
    the JAX package (`quantize.py:409-411`)."""
    stage_sizes, _, q, x, _ = tiny
    for switches in (Q.PATH_A, Q.PATH_B):
        kw = dict(out_dtype=torch.float32, **switches)
        a = Q.quantized_trunk_apply(q, torch.from_numpy(x), stage_sizes, **kw)
        b = Q.quantized_trunk_apply(q, torch.from_numpy(x), stage_sizes, int4_stage1=1, **kw)
        assert torch.equal(a, b)


@pytest.mark.parametrize("recip", [False, True])
def test_requant_u4_is_jaxs_grid(monkeypatch, recip):
    """The 4-bit grid: scale4 = scale8 · f32(127/7), values clipped to [0, 7] (unsigned)
    and [-7, 7] (signed), equal to JAX's s4 values widened to s8, in both requant forms."""
    monkeypatch.setenv("ECT_RECIP_REQUANT", "1" if recip else "0")
    x = (np.random.RandomState(4).randn(4096) * 2.0).astype(np.float32)
    s8 = np.float32(1.3 / 127)
    for port_fn, jax_fn, lo in ((requant_u4, jq._requant_u4, 0), (requant_s4, jq._requant_s4, -7)):
        want, want_s = jax.jit(jax_fn)(jnp.asarray(x), s8)
        got, got_s = port_fn(torch.from_numpy(x), torch.tensor(s8), recip)
        assert float(got_s) == float(want_s)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int8))
        assert got.min() == lo and got.max() == 7


# ------------------------------------------------------------------ the requant forms


def _boundary_values(scale: np.float32, n: int = 20000, seed: int = 5) -> np.ndarray:
    """Values whose quotient by `scale` lies within a few f32 steps of a requant
    boundary k ± 0.5 (|k| ≤ 127), where x / s and x · (1 / s) part, plus random ones."""
    rng = np.random.RandomState(seed)
    k = rng.randint(-127, 127, n).astype(np.float64) + 0.5
    x = (k * np.float64(scale)).astype(np.float32)
    steps = rng.randint(-3, 4, n).astype(np.int32)
    x = (x.view(np.int32) + steps).view(np.float32)
    return np.concatenate([x, (rng.randn(n) * 60 * scale).astype(np.float32)])


def test_recip_requant_matches_jax_on_near_ties(monkeypatch):
    """On values planted at the boundaries: the port's reciprocal requants equal the
    JAX package's under ECT_RECIP_REQUANT=1 on every element, unsigned and signed; each
    differs from the division by at most one step, on some elements. XLA on the CPU
    contracts the product and the + 0.5 into one fused multiply-add (its f32 values are
    the single-rounded ones, which differ from the separately rounded ones on some
    elements), and the s8 results still agree: the contraction cannot move a
    truncation (`ops/int8.py`)."""
    scale = np.float32(2.37 / 127)
    x = _boundary_values(scale)
    xt, st = torch.from_numpy(x), torch.tensor(scale)
    monkeypatch.setenv("ECT_RECIP_REQUANT", "1")
    for port_fn, jax_fn in ((requant, jq._requant), (requant_signed, jq._requant_signed)):
        want = np.asarray(jax.jit(jax_fn)(jnp.asarray(x), scale))
        got = port_fn(xt, st, recip=True).numpy()
        np.testing.assert_array_equal(got, want)
        div = port_fn(xt, st).numpy()
        d = np.abs(got.astype(np.int32) - div.astype(np.int32))
        assert d.max() == 1 and 0 < (d != 0).mean() < 0.5, (d.max(), (d != 0).mean())

    r = np.float32(1.0) / scale
    xla = np.asarray(jax.jit(lambda v, s: v * (jnp.float32(1.0) / s) + 0.5)(jnp.asarray(x),
                                                                            scale))
    fused = (x.astype(np.float64) * np.float64(r) + 0.5).astype(np.float32)
    separate = (xt * (torch.ones_like(st) / st) + 0.5).numpy()
    np.testing.assert_array_equal(xla, fused)
    assert (separate != fused).any()


@pytest.mark.parametrize("n,h,cin,cout", [(2, 16, 32, 64), (1, 12, 8, 16)])
def test_stem3_plain_version_recip_matches_jax_kernel(monkeypatch, n, h, cin, cout):
    monkeypatch.setenv("ECT_RECIP_REQUANT", "1")
    rng = np.random.RandomState(0)
    x = np.abs(rng.randn(n, h, h, cin)).astype(np.float32) * 0.5
    kernel = rng.randn(3, 3, cin, cout).astype(np.float32) * 0.1
    bias = rng.randn(cout).astype(np.float32) * 0.05
    scale = np.float32(2.3 / 127)
    want = np.asarray(jax_stem(jnp.asarray(x, jnp.bfloat16), kernel, bias, scale,
                               interpret=True))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    args = (xt, torch.from_numpy(kernel), torch.from_numpy(bias), torch.tensor(scale))
    got = SK.stem3_requant_pool_int8(*args, recip=True)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    dmax, share = C.step_diff(got, want)
    assert dmax <= 1 and share <= 0.005, (dmax, share)
    _one_form(lambda: SK.stem3_requant_pool_int8(*args, recip=True), True)
    assert C.step_diff(got, SK.stem3_requant_pool_int8(*args))[0] <= 1


def _jq(qnp):
    return jax.tree.map(jnp.asarray, qnp)


@contextlib.contextmanager
def every_requant_recip():
    """Every requant the port makes inside in the reciprocal form: the JAX XLA graph's
    reading of ECT_RECIP_REQUANT=1, which its Pallas K3 and K5 do not follow."""
    unscale = I8.unscale
    I8.unscale = lambda x, scale, recip=False: unscale(x, scale, True)
    try:
        yield
    finally:
        I8.unscale = unscale


def _follows_the_kernel(run, want, recip_out, divides_inside=True):
    """On planted operands, where the requant forms part on most boundaries: the port's
    kernel plain version `run(recip)` is bit-equal to the JAX Pallas kernel's `want` in
    the reciprocal form. Where the kernel divides inside (`divides_inside`), every
    requant in the reciprocal form differs from it; where its output is a requant in
    that form (`recip_out`), so does the division throughout."""
    np.testing.assert_array_equal(run(True).numpy(), want)
    with every_requant_recip():
        assert (run(True).numpy() != want).any() == divides_inside
    assert (run(False).numpy() != want).any() == recip_out


@pytest.mark.parametrize("plant", [False, True])
def test_stage1_plain_version_recip_matches_jax_kernel(monkeypatch, plant):
    """The plain K3 under `recip` takes the reciprocal form at its three block outputs
    and divides at its cb1/cb2 requants and its shortcut, as the Pallas kernel's
    `_unscale` does (`bottleneck_kernel.py:249-308`). Random operands: within K3's
    contract of the JAX kernel; planted ones (the shortcut's sum exact): bit-equal."""
    monkeypatch.setenv("ECT_RECIP_REQUANT", "1")
    rng = np.random.RandomState(0)
    qnp = C.planted_stage1_q() if plant else C.stage1_q(rng)
    x8 = C.s8(rng, (2, 14, 14, 64), hi=12 if plant else 90)
    want = np.asarray(jbk.fused_stage1_int8(jnp.asarray(x8),
                                            jax.jit(jq.stage1_int8_operands)(_jq(qnp)),
                                            interpret=True))
    ops = Q.stage1_int8_operands(C.to_torch(qnp))

    def run(recip):
        return BK.fused_stage1_int8(torch.from_numpy(x8), ops, recip=recip)

    with requant_forms() as forms:
        got = run(True)
    assert forms == [False, False, False, True] + [False, False, True] * 2, forms
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape == (2, 14, 14, 256)
    dmax, share = C.step_diff(got, want)
    assert dmax <= 1 and share <= 0.005, (dmax, share)
    if plant:
        _follows_the_kernel(run, want, recip_out=True)
    else:
        assert C.step_diff(got, run(False))[0] <= 1


@pytest.mark.parametrize("plant", [False, True])
@pytest.mark.parametrize("cin,cm,n,h", [(256, 64, 2, 7), (1280, 64, 2, 4)])
def test_cb3_cb1_plain_version_recip_matches_jax_kernel(monkeypatch, cin, cm, n, h, plant):
    """The plain K4 under `recip` takes both its requants in the reciprocal form, as the
    Pallas kernel does (`bottleneck_kernel.py:518,533`): bit-equal to it."""
    monkeypatch.setenv("ECT_RECIP_REQUANT", "1")
    rng = np.random.RandomState(1)
    qnp, names = C.planted_identity_q(cin, cm, 2) if plant else C.identity_q(rng, cin, cm, 2)
    r_res = C.PLANT_SCALE if plant else np.float32(1.9 / 127)
    hi = 12 if plant else 90
    x8, res8 = C.s8(rng, (n, h, h, cm), hi), C.s8(rng, (n, h, h, cin), hi)
    ops = jax.jit(lambda q: jq.cb3_cb1_operands(q, names[0], names[1], r_res))(_jq(qnp))
    want = jbk.fused_cb3_cb1_int8(jnp.asarray(x8), jnp.asarray(res8), ops, interpret=True)
    tops = Q.cb3_cb1_operands(C.to_torch(qnp), names[0], names[1], torch.tensor(r_res))

    def run(recip):
        return BK.fused_cb3_cb1_int8(torch.from_numpy(x8), torch.from_numpy(res8), tops,
                                     recip=recip)

    with requant_forms() as forms:
        got = run(True)
    assert forms == [True, True], forms
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        if plant:
            _follows_the_kernel(lambda recip, i=i: run(recip)[i], np.asarray(w), True,
                                divides_inside=False)


@pytest.mark.parametrize("plant", [False, True])
@pytest.mark.parametrize("out_dtype", ["int8", "bfloat16"])
def test_resblocks_plain_version_recip_matches_jax_kernel(monkeypatch, out_dtype, plant):
    """The plain K5 under `recip` takes the reciprocal form at its s8 output only and
    divides at its cb1, cb2 and inter-block requants, as the Pallas kernel's `_unscale`
    does (`bottleneck_kernel.py:383-420`): bit-equal to it."""
    monkeypatch.setenv("ECT_RECIP_REQUANT", "1")
    rng = np.random.RandomState(2)
    qnp, names = C.planted_identity_q(32, 16, 3) if plant else C.identity_q(rng, 32, 16, 3)
    s_in = C.PLANT_SCALE if plant else np.float32(1.8 / 127)
    s_next = (np.float32(qnp["act_scales"][f"{names[-1]}.out"]) if out_dtype == "int8"
              else np.float32(1.0))
    x8 = C.s8(rng, (2, 6, 6, 32), 12 if plant else 90)
    ops, scl = jax.jit(lambda q: jq.resblocks_int8_operands(q, names, s_in, s_next))(_jq(qnp))
    want = np.asarray(jbk.fused_resblocks_int8(jnp.asarray(x8), ops, scl,
                                               out_dtype=getattr(jnp, out_dtype),
                                               interpret=True), np.float32)
    tops, tscl = Q.resblocks_int8_operands(C.to_torch(qnp), names, torch.tensor(s_in),
                                           torch.tensor(s_next))

    def run(recip):
        return BK.fused_resblocks_int8(torch.from_numpy(x8), tops, tscl,
                                       out_dtype=getattr(torch, out_dtype),
                                       recip=recip).float()

    with requant_forms() as forms:
        got = run(True)
    assert forms == [False] * 8 + [True] * (out_dtype == "int8"), forms
    np.testing.assert_array_equal(got.numpy(), want)
    if plant:
        _follows_the_kernel(run, want, recip_out=out_dtype == "int8")


# ------------------------------------------------------------- torchvision and the ViT


@pytest.fixture(scope="module")
def tv18():
    """A width-8 folded ResNet-18 layout (both packages' trees) and its input."""
    cfg = RESNET_CONFIGS["resnet18"]
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    variables = _np(JaxTVResNet(width=8, **cfg).init(jax.random.PRNGKey(1), jnp.asarray(x)))
    folded = _np(jax.jit(fold_conv_bn_tree)(variables["params"], variables["batch_stats"]))
    qj = _np(jax.jit(lambda p, xx: jq.quantize_resnet_trunk(p, cfg["stage_sizes"],
                                                            cfg["block"], xx))(folded, x))
    return cfg, qj, x


def test_resnet_recip_matches_jax(tv18, monkeypatch):
    cfg, qj, x = tv18
    _jax_env(monkeypatch, {"ECT_RECIP_REQUANT": "1"})
    want = np.asarray(jax.jit(lambda q, xx: jq.quantized_resnet_apply(
        q, xx, cfg["stage_sizes"], cfg["block"], out_dtype=jnp.float32))(_jq(qj), x))
    q = from_flax_qtrunk(qj)
    got = _one_form(lambda: Q.quantized_resnet_apply(
        q, torch.from_numpy(x), cfg["stage_sizes"], cfg["block"], out_dtype=torch.float32,
        recip_requant=True), True)
    assert cosine_distance(got, want) < 1e-5


@pytest.fixture(scope="module")
def vit_case():
    """JAX's quantized `clip_vit_tiny` tower (f32) as numpy, the port's copy, and the
    preprocessed golden frames."""
    enc = jax_build_encoder("clip_vit_tiny", dtype=jnp.float32)
    x = np.array(enc.preprocess(jnp.asarray(golden_frames(8, size=96))))
    nh, nl = CLIP_VIT_CONFIGS["ViTtiny"]["num_heads"], CLIP_VIT_CONFIGS["ViTtiny"]["layers"]
    qj = CC.tree_np(jax.jit(lambda p, xx: jax_quantize_vit(p, xx, nh, nl))(
        enc.variables["params"]["vit"], jnp.asarray(x)))
    return qj, from_flax_qvit(qj), x, nh, nl


VIT_OPTIONS = {
    "quant_attn_off": (dict(quant_attn=False), {"ECT_VIT_QUANT_ATTN": "0"}),
    # JAX's conv-form out-proj is an emitter choice: the port's one s8 GEMM matches it.
    "conv_out": ({}, {"ECT_VIT_CONV_OUT": "1"}),
    "recip": (dict(recip_requant=True), {"ECT_RECIP_REQUANT": "1"}),
}


@pytest.mark.parametrize("option", list(VIT_OPTIONS))
def test_vit_option_matches_jax(vit_case, monkeypatch, option):
    qj, q, x, nh, nl = vit_case
    port_kw, env = VIT_OPTIONS[option]
    _jax_env(monkeypatch, env)
    want = np.asarray(jax.jit(lambda qq, xx: jax_qvit_apply(qq, xx, nh, nl,
                                                            out_dtype=jnp.float32))(
        jax.tree.map(jnp.asarray, qj), jnp.asarray(x)))
    got = quantized_vit_apply(q, torch.from_numpy(x), nh, nl, out_dtype=torch.float32,
                              **port_kw)
    assert got.shape == want.shape
    d = cosine_distance(got, want)
    assert d < 1e-5, (option, d)
    if option == "conv_out":  # and it is bit-equal to JAX's default form
        _jax_env(monkeypatch, {})
        np.testing.assert_array_equal(want, np.asarray(jax.jit(
            lambda qq, xx: jax_qvit_apply(qq, xx, nh, nl, out_dtype=jnp.float32))(
                jax.tree.map(jnp.asarray, qj), jnp.asarray(x))))


def test_vit_options_change_what_they_should(vit_case):
    """quant_attn=False changes the embedding; every requant takes the reciprocal form."""
    _, q, x, nh, nl = vit_case
    xt = torch.from_numpy(x)
    base = quantized_vit_apply(q, xt, nh, nl, out_dtype=torch.float32)
    assert not torch.equal(quantized_vit_apply(q, xt, nh, nl, out_dtype=torch.float32,
                                               quant_attn=False), base)
    _one_form(lambda: quantized_vit_apply(q, xt, nh, nl, recip_requant=True), True)


def test_from_flax_carries_the_option_entries(tiny, vit_case):
    """`from_flax_qtrunk` carries the s8 stem2/stem3 entries, `from_flax_qvit` the bf16
    attention weights (transposed to the Linear layout), both bit-equal."""
    _, qj, q, _, _ = tiny
    for name in ("stem2", "stem3"):
        assert q[name]["kernel_q"].dtype == torch.int8
        for leaf in ("kernel_q", "w_scale", "bias"):
            np.testing.assert_array_equal(q[name][leaf].numpy(), qj[name][leaf])
    qjv, qv, _, _, nl = vit_case
    for i in range(nl):
        fb = qjv["fp"]["transformer"][f"block{i}"]["attn"]
        for name, key in zip(ATTN_DENSES, ("attn.in_proj_weight", "attn.out_proj.weight")):
            w = qv["fp"][f"transformer.resblocks.{i}.{key}"]
            assert w.dtype == torch.bfloat16
            np.testing.assert_array_equal(w.float().numpy(),
                                          np.asarray(fb[name]["kernel"], np.float32).T)


def test_port_quantizers_make_the_option_entries():
    """The port's own `quantize_trunk` makes the s8 stem entries JAX's makes (bit-equal
    on the same folded weights), and its `quantize_vit` keeps the bf16 attention weights."""
    frames = golden_frames(2, size=96)
    jenc = jax_build_encoder("clip_rn_tiny", dtype=jnp.float32)
    enc = build_encoder("clip_rn_tiny", device="cpu")
    enc.load_torch_state_dict(from_flax_variables(_np(jenc.variables)))
    qj = _np(jenc.fold_bn().quantize(frames).qtrunk)
    q = enc.quantize(frames).qtrunk
    for name in ("stem2", "stem3"):
        np.testing.assert_array_equal(q[name]["kernel_q"].numpy(), qj[name]["kernel_q"])
        np.testing.assert_array_equal(q[name]["bias"].numpy(), qj[name]["bias"])
    venc = build_encoder("clip_vit_tiny", device="cpu")
    qv = venc.quantize(frames).qtrunk
    sd = venc.module.state_dict()
    for i in range(CLIP_VIT_CONFIGS["ViTtiny"]["layers"]):
        for key in ("attn.in_proj_weight", "attn.out_proj.weight"):
            k = f"transformer.resblocks.{i}.{key}"
            assert torch.equal(qv["fp"][k], sd[k].to(torch.bfloat16))


# ------------------------------------------------------------------ the encoders' slice


def test_int8_encoders_take_the_options(tiny, monkeypatch):
    """The whole slice: the port's int8 `clip_rn_tiny` encoder on JAX's weights with
    `with_kernels(recip_requant=True, int8_stem="full")` against JAX's int8 encoder
    under ECT_RECIP_REQUANT=1 ECT_INT8_STEM=full, per key ≤1e-3 cosine (the encoders'
    preprocess and attention pools differ by their own contracts); the ViT and ResNet
    encoders' `with_kernels`."""
    frames = tiny[4]
    jenc = jax_build_encoder("clip_rn_tiny", dtype=jnp.float32)
    enc = build_encoder("clip_rn_tiny", device="cpu")
    enc.load_torch_state_dict(from_flax_variables(_np(jenc.variables)))
    _jax_env(monkeypatch, {"ECT_RECIP_REQUANT": "1", "ECT_INT8_STEM": "full"})
    want = jenc.fold_bn().quantize(frames[:2]).encode(frames)
    qenc = enc.fold_bn().quantize(frames[:2])
    opt = qenc.with_kernels(recip_requant=True, int8_stem="full")
    assert opt.kernels == {**Q.PATH_A, "recip_requant": True, "int8_stem": "full"}
    got = opt.encode(frames)
    for k in got:
        assert cosine_distance(got[k], np.asarray(want[k], np.float32)) <= 1e-3, k
    assert not torch.equal(got["clip_conv"], qenc.encode(frames)["clip_conv"])

    g = golden_frames(4, size=96)
    vq = build_encoder("clip_vit_tiny", device="cpu").quantize(g)
    assert not torch.equal(vq.with_kernels(quant_attn=False).encode(g)["clip_embed"],
                           vq.encode(g)["clip_embed"])
    rq = build_encoder("imagenet_rn18", device="cpu").fold_bn().quantize(golden_frames(1))
    r = rq.with_kernels(recip_requant=True)
    assert r.kernels == {"recip_requant": True} and r.qtrunk is rq.qtrunk


# ----------------------------------------------------------------------- resize


@pytest.mark.parametrize("layout", ["nhwc", "hwc", "float"])
@pytest.mark.parametrize("size,crop", [(224, (224, 224)), ((100, 150), None)])
def test_resize_bicubic_matches_jax(layout, size, crop):
    """`ops.resize_bicubic` against the JAX package's, at the port's resize tolerance
    (`test_torch_preprocess.py`: ≤1.5 uint8 LSB, <1e-3 of pixels beyond 0.5 LSB)."""
    frames = np.random.RandomState(3).randint(0, 256, (2, 300, 280, 3), np.uint8)
    if layout == "hwc":
        frames = frames[0]
    elif layout == "float":
        frames = frames.astype(np.float32) / 255.0
    want = np.asarray(jax_resize.resize_bicubic(jnp.asarray(frames), size, crop))
    got = resize_bicubic(torch.from_numpy(frames), size, crop).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.abs(got - want) * 255.0
    assert err.max() <= 1.5 and (err > 0.5).mean() < 1e-3, err.max()


# ---------------------------------------------------------- full-width fidelity (slow)


@pytest.fixture(scope="module")
def rn50_int8():
    """Full-size clip_rn50 on the port's seed-0 weights in both packages: the f32
    unfolded reference features on golden_frames(8), JAX's and the port's bf16 int8
    encoders calibrated on golden_frames(32)."""
    from embodied_clip_tpu_torch.models.encoders import ENCODER_SPECS, _random_state_dict

    sd = _random_state_dict(ENCODER_SPECS["clip_rn50"], 0)
    g8, g32 = golden_frames(8), golden_frames(32)
    jref = jax_build_encoder("clip_rn50", dtype=jnp.float32).load_torch_state_dict(sd)
    ref = {k: np.asarray(v, np.float32) for k, v in jref.encode(g8).items()}
    jenc = jax_build_encoder("clip_rn50", dtype=jnp.bfloat16).load_torch_state_dict(sd)
    qj = jenc.fold_bn().quantize(g32)
    qp = build_encoder("clip_rn50", dtype=torch.bfloat16, device="cpu").fold_bn().quantize(g32)
    return ref, qj, qp, g8


# option → (the port's `with_kernels` keywords, the JAX package's environment)
RN50_OPTIONS = {
    "recip": (dict(recip_requant=True), {"ECT_RECIP_REQUANT": "1"}),
    "stem3": (dict(int8_stem="stem3"), {"ECT_INT8_STEM": "stem3"}),
    "full": (dict(int8_stem="full"), {"ECT_INT8_STEM": "full"}),
    "int4_1": (dict(**Q.KERNELS_OFF, int4_stage1=1), {"ECT_INT4_STAGE1": "1"}),
    "int4_2": (dict(**Q.KERNELS_OFF, int4_stage1=2), {"ECT_INT4_STAGE1": "2"}),
}


@pytest.mark.slow
@pytest.mark.parametrize("option", list(RN50_OPTIONS))
def test_rn50_int8_option_fidelity_matches_jax(rn50_int8, monkeypatch, option):
    """Each option's int8 cosine distance to f32 per key at full width, the JAX
    package's own beside the port's (path A's kernels on their plain versions; int4 on
    the plain graph, where it runs). Where JAX's own distance passes the int8 limits of
    `chip_smoke.py` (pooled keys 1e-3, `clip_conv` 2e-3; int4 5e-2 on every key, JAX's
    envelope at `tests/test_quantize.py:121`), the card is held to those; where it does
    not, to JAX's rounded up. The port is held to the same limits here, and its conv map,
    where the options act, no farther from f32 than JAX's (the pooled keys add the
    heads' own bf16 differences, ~2e-5). Run with -s to see both."""
    ref, qj, qp, g8 = rn50_int8
    kw, env = RN50_OPTIONS[option]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = qj.encode(g8)
    dist = {"jax": {k: cosine_distance(np.asarray(out[k], np.float32), ref[k]) for k in ref}}
    got = qp.with_kernels(**kw).encode(g8)
    dist["port"] = {k: cosine_distance(got[k], ref[k]) for k in ref}
    print(f"\nint8 {option} vs f32 cosine distance, clip_rn50 seed 0: {dist}")
    limits = (dict.fromkeys(ref, 5e-2) if option.startswith("int4")
              else {"clip_conv": 2e-3, "clip_avgpool": 1e-3, "clip_attnpool": 1e-3})
    for k in ref:
        assert dist["jax"][k] <= limits[k] and dist["port"][k] <= limits[k], (k, dist)
    assert dist["port"]["clip_conv"] <= 1.1 * dist["jax"]["clip_conv"] + 1e-5, dist
