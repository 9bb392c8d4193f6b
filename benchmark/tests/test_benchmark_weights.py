"""The seeded weights (`harness/weights.py`): the existing references draw what the
parent commit drew, bit for bit, and a CLIP ViT's every parameter gets a distribution."""

import hashlib
import json
import math

import pytest
import torch

from benchmark.harness.cell import REPO
from benchmark.harness.inputs import POLICY, reference_module
from benchmark.harness.weights import BIAS_STD, BN_SHIFT, BN_SPREAD, fill_, seeded_generator
from benchmark.reference import actor_critic_ppo, clip_vision_transformer
from benchmark.tests.conftest import VIT_TINY

# sha256 (first 16 hex digits) over each filled state dict's names and bytes, in order,
# as the commit before the transformer's distributions were added gives them.
PARENT = {
    ("clip_rn50_int8", 0): "936ade9eabff142b", ("clip_rn50_int8", 1): "f795894e6cb47dd9",
    ("imagenet_rn50_bf16", 0): "dad4d13c274198b6",
    ("imagenet_rn50_bf16", 1): "4a155b484840f889",
    ("actor_critic_ppo", 0): "7b9f25c829abd589", ("actor_critic_ppo", 1): "b255984d84c52f09"}

# ViT-L/14@336px's widths (openai/CLIP `_MODELS["ViT-L/14@336px"]`), two of its 24 blocks:
# every kind of parameter at its published size.
VIT_L14_336_WIDTHS = {"patch_size": 14, "width": 1024, "layers": 2, "heads": 16,
                      "output_dim": 768, "image_size": 336}


def _digest(module: torch.nn.Module) -> str:
    h = hashlib.sha256()
    for k, v in module.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _policy(seed: int) -> torch.nn.Module:
    from embodied_clip_tpu_torch.envs.gridworld import GridNavEnv

    traffic = json.loads((REPO / "benchmark" / "traffic" / "ddppo_gridnav.json").read_text())
    env = GridNavEnv(**traffic["env"])
    with torch.device("meta"):
        policy = actor_critic_ppo.build((7, 7, 2048), env.num_actions, env.num_classes,
                                        traffic["hidden"])
    return fill_(policy.to_empty(device="cpu"), seeded_generator(seed, POLICY, "cpu"))


@pytest.mark.parametrize("name,seed", list(PARENT))
def test_existing_references_draw_the_parents_weights(name, seed):
    torch.set_num_threads(4)
    if name == "actor_critic_ppo":
        module = _policy(seed)
    else:
        cfg = json.loads((REPO / "benchmark" / "configs" / f"{name}.json").read_text())
        module = reference_module(cfg, seed, "cpu")
    assert _digest(module) == PARENT[(name, seed)]


@pytest.mark.parametrize("model", [VIT_TINY, VIT_L14_336_WIDTHS], ids=["tiny", "l14_336"])
def test_vit_every_parameter_is_drawn(model):
    torch.set_num_threads(4)
    with torch.device("meta"):
        ref = clip_vision_transformer.build({"model": model})
    ref = ref.to_empty(device="cpu")
    for t in ref.parameters():
        t.data.fill_(math.nan)   # what no draw reaches stays NaN
    fill_(ref, seeded_generator(5, 1, "cpu")).requires_grad_(False)
    w = model["width"]
    for name, t in ref.named_parameters():
        assert bool(torch.isfinite(t).all()), name
        assert not bool((t == 0).all()) and not bool((t == 1).all()), name
        assert float(t.std()) > 0, name
        if name.startswith(("ln_", "transformer.resblocks.0.ln_")):
            if name.endswith("weight"):
                assert float(t.min()) >= 1 - BN_SPREAD and float(t.max()) <= 1 + BN_SPREAD
            else:
                assert float(t.std()) == pytest.approx(BN_SHIFT, rel=0.5)
    for name in ("class_embedding", "positional_embedding", "proj"):
        std = float(getattr(ref, name).std())
        assert std == pytest.approx(w ** -0.5, rel=0.3 if name == "class_embedding" else 0.1)
    attn = ref.transformer.resblocks[0].attn
    # Truncated LeCun-normal of fan-in width: std width^-1/2, nothing past 2 std / 0.88.
    assert float(attn.in_proj_weight.std()) == pytest.approx(w ** -0.5, rel=0.1)
    assert float(attn.in_proj_weight.abs().max()) <= 2 * w ** -0.5 / 0.87962566103423978
    assert float(attn.in_proj_bias.std()) == pytest.approx(BIAS_STD, rel=0.3)
