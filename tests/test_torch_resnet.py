"""The port's torchvision ResNet (`embodied_clip_tpu_torch/models/resnet.py`) vs the JAX
package's `ResNet` and vs the torchvision-named torch oracle, on the CPU.

ResNet-18 and ResNet-50 layouts at width 8 with non-trivial BN statistics (numpy
seeds). JAX weights reach the port through `from_flax_resnet_variables`:
  f32   atol/rtol 2e-4 on the conv map (the contract of tests/test_model_parity.py),
        unfolded and BN-folded (by JAX, or by the port's `fold_conv_bn_state_dict`);
  bf16  ≤1e-3 cosine distance per sample. The port's folded bf16 ResNet-50 runs
        layer1 through K7 and the identity blocks through K6 (their plain versions
        here); JAX's runs XLA convs, which round elsewhere.
The oracle check needs no JAX: `tests/torch_oracle.py:TVResNetTrunk`'s state_dict
loads strictly, unfolded and folded.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_clip_tpu.models.resnet import ResNet as JaxResNet
from embodied_clip_tpu.ops.fold_bn import fold_conv_bn_tree

from embodied_clip_tpu_torch.models.convert import from_flax_resnet_variables
from embodied_clip_tpu_torch.models.resnet import RESNET_CONFIGS, ResNet
from embodied_clip_tpu_torch.ops.fold_bn import fold_conv_bn_state_dict
from embodied_clip_tpu_torch.parity import cosine_distance

import torch_oracle as O


def _perturb_bn(variables, seed):
    rng = np.random.RandomState(seed)
    draw = {"scale": lambda s: rng.normal(1.0, 0.2, s), "bias": lambda s: rng.normal(0.0, 0.2, s),
            "mean": lambda s: rng.normal(0.0, 0.5, s), "var": lambda s: rng.uniform(0.5, 1.5, s)}

    def perturb(tree):
        for k, v in tree.items():
            if k == "bn":
                tree[k] = {n: draw[n](a.shape).astype(np.float32) for n, a in v.items()}
            elif isinstance(v, dict):
                perturb(v)

    perturb(variables["params"])
    perturb(variables["batch_stats"])
    return variables


@pytest.fixture(scope="module", params=["resnet18", "resnet50"])
def jax_resnet(request):
    """(arch, unfolded numpy variables, input) for a width-8 JAX ResNet."""
    arch = request.param
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    module = JaxResNet(width=8, **RESNET_CONFIGS[arch])
    variables = jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    return arch, _perturb_bn(variables, 2), x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("route", ["unfolded", "folded_by_jax", "folded_by_port"])
def test_resnet_matches_jax(jax_resnet, dtype, route):
    arch, variables, x = jax_resnet
    cfg = RESNET_CONFIGS[arch]
    folded = route != "unfolded"
    jvars = variables
    if folded:
        jvars = {"params": jax.tree.map(np.asarray, jax.jit(fold_conv_bn_tree)(
            variables["params"], variables["batch_stats"]))}
    jmod = JaxResNet(width=8, dtype=getattr(jnp, dtype), folded=folded, **cfg)
    ref = np.asarray(jax.jit(jmod.apply)(jvars, jnp.asarray(x)), np.float32)
    if route == "folded_by_port":
        sd = fold_conv_bn_state_dict(from_flax_resnet_variables(variables))
    else:
        sd = from_flax_resnet_variables(jvars)
    port = ResNet(width=8, dtype=getattr(torch, dtype), folded=folded, **cfg).eval()
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == ref.shape
    assert port.runs_fused_plan == (folded and dtype == "bfloat16")
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=2e-4)
    else:
        assert cosine_distance(got, ref) <= 1e-3


@pytest.mark.parametrize("block,stage_sizes", [("basic", (2, 2, 2, 2)),
                                               ("bottleneck", (3, 2, 2, 2))])
def test_torchvision_state_dict_loads_and_matches_oracle(block, stage_sizes):
    torch.manual_seed(3)
    oracle = O.TVResNetTrunk(stage_sizes, width=8, block=block).eval()
    gen = torch.Generator().manual_seed(4)
    for m in oracle.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            with torch.no_grad():
                m.running_mean.normal_(0, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.weight.normal_(1.0, 0.2, generator=gen)
                m.bias.normal_(0, 0.2, generator=gen)
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 3, 64, 64).astype(np.float32))
    with torch.no_grad():
        ref = oracle(x).permute(0, 2, 3, 1).numpy()
        for folded in (False, True):
            port = ResNet(stage_sizes, block, width=8, folded=folded).eval()
            sd = oracle.state_dict()  # strict: the names are torchvision's
            port.load_state_dict(fold_conv_bn_state_dict(sd) if folded else sd)
            got = port(x.permute(0, 2, 3, 1))
            np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=2e-4)
    folded_sd = fold_conv_bn_state_dict(oracle.state_dict())
    assert not any(".bn" in k or k.startswith("bn") or "downsample.1" in k for k in folded_sd)
    assert "layer2.0.downsample.0.bias" in folded_sd and "conv1.bias" in folded_sd


def test_fused_plan_routes_bottleneck_trunks():
    """ResNet-50 layout: layer1 is one K7 step, every later stride-1 block a K6 step, the
    stride-2 blocks their own forward; ResNet-18 (basic blocks) runs no kernel."""
    rn50 = ResNet(**RESNET_CONFIGS["resnet50"], width=8, dtype=torch.bfloat16, folded=True)
    assert [k for k, _ in rn50.fused_plan()] == (
        ["stage1"] + ["module"] + ["bottleneck"] * 3 + ["module"] + ["bottleneck"] * 5
        + ["module"] + ["bottleneck"] * 2)
    rn18 = ResNet(**RESNET_CONFIGS["resnet18"], width=8, dtype=torch.bfloat16, folded=True)
    assert {k for k, _ in rn18.fused_plan()} == {"module"}
    assert rn50.runs_fused_plan
