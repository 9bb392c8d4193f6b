"""The torchvision int8 graph's stem and shortcut convs against the JAX XLA graph.

The JAX package's `quantized_resnet_apply` (`embodied_clip_tpu/ops/quantize.py:690-695`)
runs its 7×7/2 stem and its 1×1 `down` convs as `_conv(bf16, bf16).astype(f32)`. Its
encoders jit the graph, and XLA on the CPU leaves those outputs unrounded: each equals
the full-f32 conv of the upcast bf16 operands. The port runs them in that form
(`ops/quantize._fp_conv`), as it runs the CLIP stems
(`tests/test_torch_stem_settle.py`). Held here, for the full-size `imagenet_rn18` (basic
blocks) and a width-8 ResNet-50 layout (the bottleneck trunk, random BN folded in):
  - the s8 stem output after the int8 max pool equals the JAX XLA graph's on every
    element;
  - every s8 `down` output, on the same s8 input, equals the JAX XLA graph's but where
    the f32 sum order (cuDNN's or oneDNN's against XLA's) flips a requant tie: ≤1 step on
    ≤1e-4 of elements (about 20 times the share measured on the CPU, ≤5e-6), where the
    bf16-rounded conv is steps away on a large share;
  - the whole int8 graph from the preprocessed frames (the stem included) within cosine
    1e-5 of JAX's jitted graph.
The JAX side is the graph's own lines (`fp_conv`, `_requant`, `_max_pool_int8`,
`_requant_signed`) in one jit, and its encoder's jitted `quantized_resnet_apply`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_clip_tpu.models.encoders import build_encoder as jax_build_encoder
from embodied_clip_tpu.models.resnet import ResNet as JaxTVResNet
from embodied_clip_tpu.ops import quantize as jq
from embodied_clip_tpu.ops.fold_bn import fold_conv_bn_tree

from embodied_clip_tpu_torch.models.convert import from_flax_qtrunk
from embodied_clip_tpu_torch.models.resnet import RESNET_CONFIGS
from embodied_clip_tpu_torch.ops import quantize as Q
from embodied_clip_tpu_torch.ops.int8 import max_pool_int8, requant_signed
from embodied_clip_tpu_torch.parity import cosine_distance, golden_frames

import torch_int8_cases as C


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=["imagenet_rn18", "resnet50_w8"])
def case(request):
    """(stage sizes, block, JAX's qtrunk as numpy, preprocessed NHWC input)."""
    if request.param == "imagenet_rn18":
        enc = jax_build_encoder("imagenet_rn18", dtype=jnp.float32).fold_bn()
        frames = golden_frames(2)
        qenc = enc.quantize(frames)
        x = np.array(qenc.preprocess(jnp.asarray(frames)))
        return qenc.stage_sizes, qenc.block, _np(qenc.qtrunk), x
    cfg = RESNET_CONFIGS["resnet50"]
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    module = JaxTVResNet(width=8, **cfg)
    variables = _np(module.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    rng = np.random.RandomState(2)
    folded = _np(jax.jit(fold_conv_bn_tree)(variables["params"], variables["batch_stats"]))
    folded = jax.tree_util.tree_map_with_path(  # nonzero biases, as a folded BN leaves
        lambda path, v: (v + rng.normal(0.0, 0.05, v.shape)).astype(np.float32)
        if path[-1].key == "bias" else v, folded)
    qj = _np(jax.jit(lambda p, xx: jq.quantize_resnet_trunk(p, cfg["stage_sizes"],
                                                            cfg["block"], xx))(folded, x))
    return cfg["stage_sizes"], cfg["block"], qj, x


def _fp_conv(q, name, t, stride):
    """The JAX graph's `fp_conv` (`quantize.py:690-695`), bias in, no relu."""
    sub = q["fp"][name]["conv"]
    out = jq._conv(t.astype(jnp.bfloat16), jnp.asarray(sub["kernel"], jnp.bfloat16), stride)
    return out.astype(jnp.float32) + jnp.asarray(sub["bias"], jnp.float32)


def _port_calls(q, x, stage_sizes, block):
    """The port's graph on x, with the s8 stem output and every `down` conv's input and
    s8 output recorded."""
    calls, seen = [], []
    fp_conv, requant = Q._fp_conv, Q.requant

    def record_fp(qq, name, t, stride=1, **kw):
        out = fp_conv(qq, name, t, stride, **kw)
        calls.append((name, t, stride, out))
        return out

    Q._fp_conv = record_fp
    Q.requant = lambda *a: seen.append(requant(*a)) or seen[-1]
    try:
        out = Q.quantized_resnet_apply(q, torch.from_numpy(x), stage_sizes, block,
                                       out_dtype=torch.float32)
    finally:
        Q._fp_conv, Q.requant = fp_conv, requant
    return out, max_pool_int8(seen[0]), [c for c in calls if c[0].endswith("/down")]


def test_stem_and_down_outputs_equal_jax_xla(case):
    stage_sizes, block, qj, x = case
    q = from_flax_qtrunk(qj)
    _, stem8, downs = _port_calls(q, x, stage_sizes, block)
    a = qj["act_scales"]

    want = np.asarray(jax.jit(lambda xx: jq._max_pool_int8(jq._requant(
        _fp_conv(qj, "stem", xx, 2), a["stem.out"])))(jnp.asarray(x)))
    assert stem8.shape == want.shape
    assert C.step_diff(stem8, want) == (0, 0.0)

    # stages 2-4's stride blocks, and the bottleneck trunk's layer1_0 (64 → 256)
    assert len(downs) == (3 if block == "basic" else 4)
    for name, t, stride, out in downs:
        ds = a[name.replace("/down", "/down.out")]
        got = requant_signed(out, torch.tensor(ds))
        want = np.asarray(jax.jit(lambda tt, n=name, s=stride: jq._requant_signed(
            _fp_conv(qj, n, tt, s), ds))(jnp.asarray(t.numpy())))
        rounded = C.bf16_rounded_conv(q, name, t, stride, relu=False)
        port, bf16 = C.step_diff(got, want), C.step_diff(requant_signed(rounded,
                                                                        torch.tensor(ds)), want)
        print(f"\n{name} (max steps, share) from the JAX XLA graph: the port {port}, the "
              f"bf16-rounded conv {bf16}")
        assert port[0] <= 1 and port[1] <= 1e-4, (name, port)
        assert bf16[1] > 10 * port[1], (name, port, bf16)


def test_whole_graph_from_the_frames_matches_jax(case):
    stage_sizes, block, qj, x = case
    q = from_flax_qtrunk(qj)
    got = Q.quantized_resnet_apply(q, torch.from_numpy(x), stage_sizes, block,
                                   out_dtype=torch.float32)
    want = np.asarray(jax.jit(lambda qq, xx: jq.quantized_resnet_apply(
        qq, xx, stage_sizes, block, out_dtype=jnp.float32))(qj, jnp.asarray(x)))
    d = cosine_distance(got, want)
    print(f"\nint8 graph from the frames vs JAX's jitted graph: cosine distance {d:.3e}")
    assert got.shape == want.shape and d < 1e-5
