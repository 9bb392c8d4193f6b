"""The port's int8 PTQ trunk (`embodied_clip_tpu_torch/ops/quantize.py`) vs the JAX
package's (`embodied_clip_tpu/ops/quantize.py`), on the CPU.

Same folded weights (carried across by `from_flax_variables`), same inputs:
  - calibration scales within rtol 1e-5 (f32 convs, summed in other orders);
  - quantized s8 kernels, weight scales and biases bit-equal;
  - the plain graph (every kernel off) on a carried-across `qtrunk`: every s8 tensor the
    graph requantizes, from the stem's s8 output on, bit-exact but for ±1 step on
    ≤0.5% of elements where the bf16 shortcut's f32 sum order flips a tie;
  - the kernel dispatch (paths A and B, on the kernels' plain versions) vs JAX's with
    its Pallas kernels in interpret mode, on a trunk with identity blocks;
  - the whole slice: port int8 `clip_rn_tiny` vs JAX int8 with ECT_PALLAS_STEM/STAGE1/
    RESBLOCKS=1, and vs the port's f32 encoder, ≤1e-3 cosine per key.
The torchvision trunk (`calibrate_resnet_trunk` / `quantize_resnet_trunk` /
`quantized_resnet_apply`, ResNet-18 and -50 layouts at width 8) is held to the same
contracts, and the full-size `imagenet_rn18` int8 encoder to JAX's at ≤1e-3 cosine.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from embodied_clip_tpu.models.clip_resnet import ModifiedResNet as JaxResNet
from embodied_clip_tpu.models.resnet import ResNet as JaxTVResNet
from embodied_clip_tpu.models.encoders import build_encoder as jax_build_encoder
from embodied_clip_tpu.ops import quantize as jq
from embodied_clip_tpu.ops.fold_bn import fold_conv_bn_tree

from embodied_clip_tpu_torch.models.convert import (
    from_flax_qtrunk,
    from_flax_resnet_variables,
    from_flax_variables,
)
from embodied_clip_tpu_torch.models.encoders import build_encoder
from embodied_clip_tpu_torch.models.resnet import RESNET_CONFIGS
from embodied_clip_tpu_torch.ops import quantize as Q
from embodied_clip_tpu_torch.ops.int8 import avg_pool_int8, max_pool_int8
from embodied_clip_tpu_torch.parity import cosine_distance

import torch_int8_cases as C

KEYS = ("clip_conv", "clip_avgpool", "clip_attnpool")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb_bn(variables, rng):
    def perturb(tree, in_bn=False):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v, in_bn or k == "bn")
            elif in_bn and k in ("scale", "var"):
                tree[k] = rng.uniform(0.6, 1.4, v.shape).astype(np.float32)
            elif in_bn:
                tree[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)

    perturb(variables["params"])
    perturb(variables["batch_stats"])
    return variables


def _trunk_sd(folded_trunk):
    """A folded JAX trunk tree → the port's trunk state_dict."""
    sd = from_flax_variables({"params": {"trunk": folded_trunk, "attnpool": {
        "positional_embedding": np.zeros((1, 1), np.float32),
        **{p: {"kernel": np.zeros((1, 1), np.float32), "bias": np.zeros(1, np.float32)}
           for p in ("q_proj", "k_proj", "v_proj", "c_proj")}}}})
    return {k: v for k, v in sd.items() if not k.startswith("attnpool.")}


@pytest.fixture(scope="module")
def trunk():
    """A width-8 folded CLIP trunk with stage sizes (3, 2, 2, 2): a 3-block stage 1 (for
    K3), identity blocks in stages 2-4 (for K4/K5), random BN folded in; its input."""
    stage_sizes = (3, 2, 2, 2)
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    module = JaxResNet(stage_sizes, 8)
    variables = _perturb_bn(_np(module.init(jax.random.PRNGKey(1), jnp.asarray(x))),
                            np.random.RandomState(2))
    folded = _np(jax.jit(fold_conv_bn_tree)(variables["params"], variables["batch_stats"]))
    return stage_sizes, folded, x


def test_calibrate_trunk_matches_jax(trunk):
    stage_sizes, folded, x = trunk
    want = _np(jax.jit(lambda p, xx: jq.calibrate_trunk(p, stage_sizes, xx))(folded, x))
    got = Q.calibrate_trunk(_trunk_sd(folded), stage_sizes, torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, err_msg=k)


def test_quantize_trunk_matches_jax(trunk):
    stage_sizes, folded, x = trunk
    want = _np(jax.jit(lambda p, xx: jq.quantize_trunk(p, stage_sizes, xx))(folded, x))
    got = Q.quantize_trunk(_trunk_sd(folded), stage_sizes, torch.from_numpy(x))
    convs = [k for k in want if "/" in k]
    assert sorted(convs) == sorted(k for k in got if "/" in k)
    for k in convs:
        assert got[k]["kernel_q"].dtype == torch.int8
        for leaf in ("kernel_q", "w_scale", "bias"):
            np.testing.assert_array_equal(got[k][leaf].numpy(), want[k][leaf], err_msg=k)
    assert set(got["fp"]) == set(want["fp"])
    for k, sub in want["fp"].items():
        np.testing.assert_array_equal(got["fp"][k]["kernel"].numpy(), sub["conv"]["kernel"])
    for k, v in want["act_scales"].items():
        np.testing.assert_allclose(got["act_scales"][k].numpy(), v, rtol=1e-5, err_msg=k)


@pytest.fixture(scope="module")
def carried(trunk):
    """JAX's quantized trunk (numpy) and the port's copy of it."""
    stage_sizes, folded, x = trunk
    qj = _np(jax.jit(lambda p, xx: jq.quantize_trunk(p, stage_sizes, xx))(folded, x))
    return stage_sizes, qj, from_flax_qtrunk(qj), x


def _run_jax_from_stem(monkeypatch, qj, x, stage_sizes, t8, **flags):
    """JAX's quantized_trunk_apply with its stem replaced by the port's s8 stem output,
    recording every _requant output."""
    from embodied_clip_tpu.ops.pallas import stem_kernel

    seen = []
    requant = jq._requant
    monkeypatch.setattr(stem_kernel, "stem3_requant_pool_int8",
                        lambda *a, **k: jnp.asarray(t8.numpy()))
    monkeypatch.setattr(jq, "_requant", lambda *a: seen.append(requant(*a)) or seen[-1])
    out = jq.quantized_trunk_apply(qj, jnp.asarray(x), stage_sizes, out_dtype=jnp.float32,
                                   pallas_stem=True, **flags)
    return np.asarray(out), [np.asarray(s) for s in seen]


def test_plain_graph_matches_jax_from_the_stem_on(carried, monkeypatch):
    stage_sizes, qj, q, x = carried
    seen = []
    requant = Q.requant
    monkeypatch.setattr(Q, "requant", lambda *a: seen.append(requant(*a)) or seen[-1])
    got = Q.quantized_trunk_apply(q, torch.from_numpy(x), stage_sizes,
                                  out_dtype=torch.float32, **Q.KERNELS_OFF)
    t8 = avg_pool_int8(seen[0], 2)  # the plain graph's first requant is the stem's
    want, want_seen = _run_jax_from_stem(monkeypatch, qj, x, stage_sizes, t8)
    assert len(seen) - 1 == len(want_seen) == 3 * sum(stage_sizes) - 1
    diffs = [C.step_diff(g, w) for g, w in zip(seen[1:], want_seen)]
    assert diffs[0] == (0, 0.0)  # stage 1's first cb1: no shortcut upstream
    for dmax, share in diffs:
        assert dmax <= 1 and share <= 0.005, diffs
    assert cosine_distance(got, want) < 1e-5


@pytest.mark.parametrize("path", ["A", "B"])
def test_kernel_dispatch_matches_jax(carried, monkeypatch, path):
    """Port dispatch on the kernels' plain versions vs JAX's dispatch on its Pallas
    kernels (interpret mode), stem fixed to the port's s8 output: K3 on stage 1, K5
    (gate lowered) or K4 on stages 2-4. Bit-exact but for shortcut ties."""
    stage_sizes, qj, q, x = carried
    monkeypatch.setattr(Q, "PALLAS_RESBLOCKS_MIN_CM", 1)
    monkeypatch.setattr(jq, "PALLAS_RESBLOCKS_MIN_CM", 1)
    switches = Q.PATH_A if path == "A" else Q.PATH_B
    plain = Q.quantized_trunk_apply(q, torch.from_numpy(x), stage_sizes,
                                    out_dtype=torch.float32, **Q.KERNELS_OFF)
    got = Q.quantized_trunk_apply(q, torch.from_numpy(x), stage_sizes,
                                  out_dtype=torch.float32, **switches)
    from embodied_clip_tpu_torch.ops.kernels import stem_kernel as SK

    sub = q["fp"]["stem3"]
    t = Q._fp_conv(q, "stem2", Q._fp_conv(q, "stem1", torch.from_numpy(x), 2))
    t8 = SK.stem3_requant_pool_int8(t.to(torch.bfloat16), sub["kernel"], sub["bias"],
                                    q["act_scales"]["stem.out"])
    flags = (dict(pallas_stage1=True, pallas_resblocks=True) if path == "A"
             else dict(pallas_stage1=True, fuse_pointwise=1))
    want, _ = _run_jax_from_stem(monkeypatch, qj, x, stage_sizes, t8, **flags)
    assert got.shape == want.shape
    assert cosine_distance(got, want) < 1e-5
    assert np.mean(np.abs(got.numpy() - want) > 1e-6) <= 0.005
    assert cosine_distance(got, plain) < 1e-3  # K2 vs the graph's stem3


@pytest.fixture(scope="module")
def tiny_int8():
    """JAX and port f32 clip_rn_tiny on the same weights, folded, and frames (the
    setup of tests/test_quantize.py)."""
    frames = np.random.RandomState(0).randint(0, 256, (4, 160, 160, 3), np.uint8)
    jenc = jax_build_encoder("clip_rn_tiny", dtype=jnp.float32)
    enc = build_encoder("clip_rn_tiny", device="cpu")
    enc.load_torch_state_dict(from_flax_variables(_np(jenc.variables)))
    return jenc.fold_bn(), enc.fold_bn(), frames


def test_int8_encoder_matches_jax_and_f32(tiny_int8, monkeypatch):
    jenc, enc, frames = tiny_int8
    for flag in ("ECT_PALLAS_STEM", "ECT_PALLAS_STAGE1", "ECT_PALLAS_RESBLOCKS"):
        monkeypatch.setenv(flag, "1")
    want = jenc.quantize(frames[:2]).encode(frames)
    qenc = enc.quantize(frames[:2])
    assert qenc.quantize(frames) is qenc and qenc.fold_bn() is qenc
    got = qenc.encode(frames)
    ref = enc.encode(frames)
    assert set(got) == set(KEYS)
    for k in KEYS:
        assert tuple(got[k].shape) == want[k].shape == tuple(ref[k].shape)
        assert got[k].dtype == torch.float32
        assert cosine_distance(got[k], np.asarray(want[k], np.float32)) <= 1e-3, k
        assert cosine_distance(got[k], ref[k]) <= 1e-3, k


@pytest.mark.slow
def test_rn50_int8_fidelity_matches_jax():
    """Full-size clip_rn50 on the port's seed-0 weights, both packages: bf16 folded,
    quantized on golden_frames(32), vs the f32 unfolded encoder on golden_frames(8).
    The port's int8 cosine distance per key is no worse than the JAX package's own
    (the limit `chip_smoke.py` holds the conv map to comes from here). Prints both."""
    from embodied_clip_tpu_torch.models.encoders import ENCODER_SPECS, _random_state_dict
    from embodied_clip_tpu_torch.parity import golden_frames

    sd = _random_state_dict(ENCODER_SPECS["clip_rn50"], 0)
    g8, g32 = golden_frames(8), golden_frames(32)
    dist = {}
    jref = jax_build_encoder("clip_rn50", dtype=jnp.float32).load_torch_state_dict(sd)
    ref = {k: np.asarray(v, np.float32) for k, v in jref.encode(g8).items()}
    jenc = jax_build_encoder("clip_rn50", dtype=jnp.bfloat16).load_torch_state_dict(sd)
    out = jenc.fold_bn().quantize(g32).encode(g8)
    dist["jax"] = {k: cosine_distance(np.asarray(out[k], np.float32), ref[k]) for k in KEYS}
    enc = build_encoder("clip_rn50", dtype=torch.bfloat16, device="cpu")
    out = enc.fold_bn().quantize(g32).encode(g8)
    dist["port"] = {k: cosine_distance(out[k], ref[k]) for k in KEYS}
    print("int8 vs f32 cosine distance, clip_rn50 seed 0:", dist)
    for k in KEYS:
        assert dist["port"][k] <= 1.1 * dist["jax"][k] + 1e-5, (k, dist)
    assert dist["port"]["clip_attnpool"] <= 1e-3 and dist["port"]["clip_avgpool"] <= 1e-3


def test_int8_encoder_paths_agree(tiny_int8):
    """Paths A and B and the plain graph, all on the CPU: A and B bit-identical."""
    _, enc, frames = tiny_int8
    qenc = enc.quantize(frames[:2])
    a = qenc.encode(frames)
    b = qenc.with_kernels(**Q.PATH_B).encode(frames)
    off = qenc.with_kernels(**Q.KERNELS_OFF).encode(frames)
    for k in KEYS:
        assert torch.equal(a[k], b[k]), k
        assert cosine_distance(a[k], off[k]) <= 1e-3, k
    assert qenc.qtrunk["layer1_0/cb2"]["kernel_q"].dtype == torch.int8
    assert all(float(s) > 0 for s in qenc.qtrunk["act_scales"].values())


# ------------------------------------------------------ torchvision trunk (imagenet)


@pytest.fixture(scope="module", params=["resnet18", "resnet50"])
def tv_trunk(request):
    """A width-8 folded torchvision ResNet (random BN folded in) in both packages' trees:
    (stage_sizes, block, JAX folded params, the port's folded state_dict, input)."""
    cfg = RESNET_CONFIGS[request.param]
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    variables = _perturb_bn(_np(JaxTVResNet(width=8, **cfg).init(
        jax.random.PRNGKey(1), jnp.asarray(x))), np.random.RandomState(2))
    folded = _np(jax.jit(fold_conv_bn_tree)(variables["params"], variables["batch_stats"]))
    sd = from_flax_resnet_variables({"params": folded})
    return cfg["stage_sizes"], cfg["block"], folded, sd, x


def _jax_q_resnet(tv_trunk):
    stage_sizes, block, folded, _, x = tv_trunk
    return _np(jax.jit(lambda p, xx: jq.quantize_resnet_trunk(p, stage_sizes, block, xx))(
        folded, x))


def test_calibrate_resnet_trunk_matches_jax(tv_trunk):
    stage_sizes, block, folded, sd, x = tv_trunk
    want = _np(jax.jit(lambda p, xx: jq.calibrate_resnet_trunk(p, stage_sizes, block, xx))(
        folded, x))
    got = Q.calibrate_resnet_trunk(sd, stage_sizes, block, torch.from_numpy(x))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-5, err_msg=k)


def test_quantize_resnet_trunk_matches_jax(tv_trunk):
    stage_sizes, block, _, sd, x = tv_trunk
    want = _jax_q_resnet(tv_trunk)
    got = Q.quantize_resnet_trunk(sd, stage_sizes, block, torch.from_numpy(x))
    convs = [k for k in want if "/" in k]
    assert sorted(convs) == sorted(k for k in got if "/" in k)
    for k in convs:
        assert got[k]["kernel_q"].dtype == torch.int8
        for leaf in ("kernel_q", "w_scale", "bias"):
            np.testing.assert_array_equal(got[k][leaf].numpy(), want[k][leaf], err_msg=k)
    assert set(got["fp"]) == set(want["fp"])
    for k, sub in want["fp"].items():
        np.testing.assert_array_equal(got["fp"][k]["kernel"].numpy(), sub["conv"]["kernel"])
        np.testing.assert_array_equal(got["fp"][k]["bias"].numpy(), sub["conv"]["bias"])


def _jitted_conv(x, kernel, stride: int = 1, pet=None):
    """JAX's `quantize._conv` as its encoders' jitted graph computes it: XLA leaves a
    conv of bf16 operands unrounded, the f32 conv of the upcast operands
    (`tests/test_torch_resnet_stem_settle.py` shows it on every element); op by op,
    JAX rounds it to bf16. s8 convs as they are."""
    if pet is None and x.dtype == jnp.bfloat16:
        x, kernel = x.astype(jnp.float32), jnp.asarray(kernel).astype(jnp.float32)
        k = kernel.shape[0]
        return lax.conv_general_dilated(
            x, kernel, (stride, stride), [((k - 1) // 2, (k - 1) // 2)] * 2,
            dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=lax.Precision.HIGHEST)
    return jq_conv(x, kernel, stride, pet)


jq_conv = jq._conv


def test_resnet_int8_graph_matches_jax_from_the_stem_on(tv_trunk, monkeypatch):
    """JAX's quantized trunk carried across by `from_flax_qtrunk` as it is; the port's s8
    stem output (after its int8 max pool) fed to JAX's graph, run op by op with its bf16
    convs in the form XLA compiles them to (`_jitted_conv`); every s8 tensor JAX
    requantizes after it bit-exact but for ±1 step on ≤0.5% of elements, where the bf16
    shortcut conv's sum order flips a tie."""
    stage_sizes, block, _, _, x = tv_trunk
    qj = _jax_q_resnet(tv_trunk)
    q = from_flax_qtrunk(qj)
    seen = []
    requant = Q.requant
    monkeypatch.setattr(Q, "requant", lambda *a: seen.append(requant(*a)) or seen[-1])
    got = Q.quantized_resnet_apply(q, torch.from_numpy(x), stage_sizes, block,
                                   out_dtype=torch.float32)
    t8 = max_pool_int8(seen[0])  # the graph's first requant is the stem's
    want_seen = []
    jrequant = jq._requant
    monkeypatch.setattr(jq, "_max_pool_int8", lambda *a, **k: jnp.asarray(t8.numpy()))
    monkeypatch.setattr(jq, "_requant",
                        lambda *a: want_seen.append(jrequant(*a)) or want_seen[-1])
    monkeypatch.setattr(jq, "_conv", _jitted_conv)
    want = np.asarray(jq.quantized_resnet_apply(qj, jnp.asarray(x), stage_sizes, block,
                                                out_dtype=jnp.float32))
    n_convs = len(Q._resnet_convs(block))
    assert len(seen) == len(want_seen) == 1 + n_convs * sum(stage_sizes) - 1
    diffs = [C.step_diff(g, np.asarray(w)) for g, w in zip(seen[1:], want_seen[1:])]
    assert diffs[0] == (0, 0.0)  # layer1_0's first requant: no shortcut upstream
    for dmax, share in diffs:
        assert dmax <= 1 and share <= 0.005, diffs
    assert got.shape == want.shape and cosine_distance(got, want) < 1e-5


def test_imagenet_int8_encoder_matches_jax_and_f32(monkeypatch):
    """Full-size imagenet_rn18, the same seed weights and frames in both packages: f32
    encoders (so both quantize the same f32 weights; a bf16 module holds them rounded),
    folded, quantized on 2 golden frames; per key ≤1e-3 cosine vs JAX's int8 encoder
    and vs the port's f32 encoder."""
    from embodied_clip_tpu_torch.parity import golden_frames

    frames = golden_frames(2)
    jenc = jax_build_encoder("imagenet_rn18", dtype=jnp.float32)
    enc = build_encoder("imagenet_rn18", device="cpu")
    enc.load_torch_state_dict(from_flax_resnet_variables(_np(jenc.variables)))
    want = jenc.fold_bn().quantize(frames).encode(frames)
    qenc = enc.fold_bn().quantize(frames)
    assert qenc.quantize(frames) is qenc and qenc.fold_bn() is qenc
    got = qenc.encode(frames)
    ref = enc.encode(frames)
    assert set(got) == {"imagenet_conv", "imagenet_avgpool"}
    for k in got:
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == want[k].shape
        assert cosine_distance(got[k], np.asarray(want[k], np.float32)) <= 1e-3, k
        assert cosine_distance(got[k], ref[k]) <= 1e-3, k


@pytest.mark.slow
def test_imagenet_rn50_int8_fidelity_matches_jax():
    """Full-size imagenet_rn50 on the port's seed-0 weights, both packages: bf16 folded,
    quantized on golden_frames(32), vs the f32 unfolded encoder on golden_frames(8).
    The port's int8 cosine distance per key is no worse than the JAX package's own
    (the limit `chip_smoke.py` holds the ImageNet int8 path to comes from here)."""
    from embodied_clip_tpu_torch.models.encoders import ENCODER_SPECS, _random_state_dict
    from embodied_clip_tpu_torch.parity import golden_frames

    sd = _random_state_dict(ENCODER_SPECS["imagenet_rn50"], 0)
    jsd = {k: v.numpy() for k, v in sd.items()}
    g8, g32 = golden_frames(8), golden_frames(32)
    keys = ("imagenet_conv", "imagenet_avgpool")
    jref = jax_build_encoder("imagenet_rn50", dtype=jnp.float32).load_torch_state_dict(jsd)
    ref = {k: np.asarray(v, np.float32) for k, v in jref.encode(g8).items()}
    jenc = jax_build_encoder("imagenet_rn50", dtype=jnp.bfloat16).load_torch_state_dict(jsd)
    out = jenc.fold_bn().quantize(g32).encode(g8)
    dist = {"jax": {k: cosine_distance(np.asarray(out[k], np.float32), ref[k]) for k in keys}}
    enc = build_encoder("imagenet_rn50", dtype=torch.bfloat16, device="cpu")
    out = enc.fold_bn().quantize(g32).encode(g8)
    dist["port"] = {k: cosine_distance(out[k], ref[k]) for k in keys}
    print("int8 vs f32 cosine distance, imagenet_rn50 seed 0:", dist)
    for k in keys:
        assert dist["port"][k] <= 1.1 * dist["jax"][k] + 1e-5, (k, dist)
