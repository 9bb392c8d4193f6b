"""PyTorch port of the CLIP ResNet tower vs the JAX package and the torch oracle.

Weights of the JAX `build_encoder("clip_rn_tiny")` go to the port through
`from_flax_variables`; the trunk is held to JAX's at
atol/rtol 2e-4 and the attention pool at 5e-4 in f32 (the contracts of
tests/test_model_parity.py), unfolded and BN-folded. The golden fixture and the
openai-named oracle check the port with no JAX involved.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_clip_tpu.models.encoders import build_encoder as jax_build_encoder

from embodied_clip_tpu_torch.models.clip import CLIPVisual
from embodied_clip_tpu_torch.models.clip_resnet import AttentionPool2d, ModifiedResNet
from embodied_clip_tpu_torch.models.convert import from_flax_variables
from embodied_clip_tpu_torch.ops.fold_bn import fold_conv_bn_state_dict

import torch_oracle as O

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "clip_rn_tiny.npz")


def _assert_close(ours, ref, atol=2e-4, rtol=2e-4):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    np.testing.assert_allclose(ours, ref, atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def jax_tiny():
    """The JAX clip_rn_tiny encoder with BN statistics made non-trivial from a numpy
    seed, and an NHWC input batch."""
    x = np.random.RandomState(0).randn(2, 128, 128, 3).astype(np.float32)
    enc = jax_build_encoder("clip_rn_tiny", dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, enc.variables)
    rng = np.random.RandomState(1)
    draw = {"scale": lambda s: rng.normal(1.0, 0.2, s), "bias": lambda s: rng.normal(0.0, 0.2, s),
            "mean": lambda s: rng.normal(0.0, 0.5, s), "var": lambda s: rng.uniform(0.5, 1.5, s)}

    def perturb(tree):
        for k, v in tree.items():
            if k == "bn":
                tree[k] = {n: draw[n](a.shape).astype(np.float32) for n, a in v.items()}
            elif isinstance(v, dict):
                perturb(v)

    perturb(variables["params"]["trunk"])
    perturb(variables["batch_stats"]["trunk"])
    enc.variables = variables
    return enc, x


@pytest.mark.parametrize("route", ["unfolded", "folded_by_jax", "folded_by_port"])
def test_clip_visual_matches_jax(jax_tiny, route):
    enc, x = jax_tiny
    jenc = enc if route == "unfolded" else enc.fold_bn()
    ref = jax.jit(jenc.module.apply)(jenc.variables, jnp.asarray(x))
    if route == "folded_by_port":
        sd = fold_conv_bn_state_dict(from_flax_variables(enc.variables))
    else:
        sd = from_flax_variables(jax.tree.map(np.asarray, jenc.variables))
    port = CLIPVisual("RNtiny", folded=route != "unfolded").eval()
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    _assert_close(got["conv"], ref["conv"])
    _assert_close(got["avgpool"], ref["avgpool"])
    _assert_close(got["embed"], ref["embed"], atol=5e-4, rtol=5e-4)


def test_golden_fixture_without_jax():
    """tests/golden/clip_rn_tiny.npz (flax-named weights, torch-oracle activations):
    the port's trunk and pool reproduce it; its pool has 2 heads on a 2x2 map."""
    with np.load(GOLDEN) as z:
        x = z["__x__"]
        conv_ref, embed_ref = z["__conv_ref__"], z["__embed_ref__"]
        tree = {}
        for key in z.files:
            if key.startswith("__"):
                continue
            node = tree
            *path, leaf = key.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    sd = from_flax_variables({
        "params": {"trunk": tree["trunk_params"], "attnpool": tree["attn_params"]},
        "batch_stats": {"trunk": tree["trunk_stats"]}})
    trunk = ModifiedResNet((1, 1, 1, 1), 8).eval()
    trunk.load_state_dict({k: v for k, v in sd.items() if not k.startswith("attnpool.")})
    pool = AttentionPool2d(2, 256, num_heads=2, output_dim=16).eval()
    pool.load_state_dict({k[len("attnpool."):]: v for k, v in sd.items()
                          if k.startswith("attnpool.")})
    with torch.no_grad():
        conv = trunk(torch.from_numpy(x))
        embed = pool(conv)
    _assert_close(conv, conv_ref, atol=5e-4, rtol=5e-4)
    _assert_close(embed, embed_ref, atol=1e-3, rtol=1e-3)


def test_openai_state_dict_loads_and_matches_oracle():
    torch.manual_seed(5)
    oracle = O.ModifiedResNetOracle((1, 1, 1, 1), 8, 4, 16, 128).eval()
    gen = torch.Generator().manual_seed(6)
    for m in oracle.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            with torch.no_grad():
                m.running_mean.normal_(0, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.weight.normal_(1.0, 0.2, generator=gen)
                m.bias.normal_(0, 0.2, generator=gen)
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 3, 128, 128).astype(np.float32))
    port = CLIPVisual("RNtiny").eval()
    port.load_state_dict(oracle.state_dict())  # strict: the names are openai's
    with torch.no_grad():
        conv_ref = oracle.trunk(x)
        embed_ref = oracle.attnpool(conv_ref)
        got = port(x.permute(0, 2, 3, 1))
    _assert_close(got["conv"], conv_ref.permute(0, 2, 3, 1))
    _assert_close(got["embed"], embed_ref, atol=5e-4, rtol=5e-4)


def test_folded_bf16_trunk_runs_k6_k7_and_matches_jax():
    """A width-8 CLIP trunk with stage sizes (3, 2, 2, 2): its folded bf16 forward runs
    stage 1 through K7 and the identity blocks of stages 2-4 through K6 (their plain
    versions on the CPU). Held to JAX's folded bf16 trunk and to the port's own f32
    trunk at ≤1e-3 cosine, and to its cuDNN route (fused_bottlenecks=False) likewise."""
    from embodied_clip_tpu.models.clip_resnet import ModifiedResNet as JaxResNet
    from embodied_clip_tpu.ops.fold_bn import fold_conv_bn_tree

    from embodied_clip_tpu_torch.parity import cosine_distance

    stage_sizes = (3, 2, 2, 2)
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    variables = jax.tree.map(np.asarray, JaxResNet(stage_sizes, 8).init(
        jax.random.PRNGKey(1), jnp.asarray(x)))
    folded = jax.tree.map(np.asarray, jax.jit(fold_conv_bn_tree)(
        variables["params"], variables["batch_stats"]))
    ref = np.asarray(jax.jit(JaxResNet(stage_sizes, 8, jnp.bfloat16, folded=True).apply)(
        {"params": folded}, jnp.asarray(x)), np.float32)
    pool = {"positional_embedding": np.zeros((1, 1), np.float32),
            **{p: {"kernel": np.zeros((1, 1), np.float32), "bias": np.zeros(1, np.float32)}
               for p in ("q_proj", "k_proj", "v_proj", "c_proj")}}
    sd = {k: v for k, v in from_flax_variables(
        {"params": {"trunk": folded, "attnpool": pool}}).items()
        if not k.startswith("attnpool.")}
    outs = {}
    for label, dtype, fused in (("k6k7", torch.bfloat16, True), ("cudnn", torch.bfloat16, False),
                                ("f32", torch.float32, True)):
        trunk = ModifiedResNet(stage_sizes, 8, dtype, folded=True, fused_bottlenecks=fused)
        trunk.load_state_dict(sd)
        with torch.no_grad():
            outs[label] = trunk(torch.from_numpy(x))
    kinds = [k for k, _ in trunk.fused_plan()]
    assert kinds.count("stage1") == 1 and kinds.count("bottleneck") == 3
    assert outs["k6k7"].dtype == torch.bfloat16 and outs["k6k7"].shape == (2, 2, 2, 256)
    assert not torch.equal(outs["k6k7"], outs["cudnn"])  # the routes round differently
    for label in ("k6k7", "cudnn"):
        assert cosine_distance(outs[label], ref) <= 1e-3, label
        assert cosine_distance(outs[label], outs["f32"]) <= 1e-3, label
