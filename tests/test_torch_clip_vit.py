"""The port's ViT visual tower, its encoder and its int8 tower
(`embodied_clip_tpu_torch/models/{clip_vit,encoders}.py`, `ops/quantize_vit.py`) against
the JAX package's, on the CPU, at the smoke-scale `ViTtiny` (width 32, 2 layers, 17
tokens).

Tolerances:
- the ViT and `build_encoder("clip_vit_tiny")`'s `encode` in f32 with the JAX weights
  carried across: atol = rtol = 5e-4, the limit at which `tests/test_model_parity.py:124`
  holds the JAX ViT to openai's layout; the bf16 encoder within 1e-3 cosine of f32 (the
  north star);
- int8: the s8 weights equal to JAX's and their scales within rtol 1e-6 (the same f32
  max and divide); the activation scales within rtol 1e-5 (maxima of an f32 forward
  whose sums run in another order); `quantized_vit_apply` on JAX's own tree carried
  across (`from_flax_qvit`) within 1e-3 cosine of JAX's, its max abs difference stated
  in the failure message (a last-ulp difference ahead of a requant can move a value by
  one s8 step); the port's int8 encoder within 2e-2 cosine of its f32 encoder, the JAX
  package's own contract (`tests/test_quantize_vit.py:27`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_clip_tpu.models.clip_vit import CLIP_VIT_CONFIGS as JAX_VIT
from embodied_clip_tpu.models.clip_vit import VisionTransformer as JaxViT
from embodied_clip_tpu.models.encoders import build_encoder as jax_build_encoder
from embodied_clip_tpu.ops.quantize_vit import quantize_vit as jax_quantize_vit
from embodied_clip_tpu.ops.quantize_vit import quantized_vit_apply as jax_qvit_apply

from embodied_clip_tpu_torch.models.clip import CLIPViTVisual
from embodied_clip_tpu_torch.models.clip_vit import CLIP_VIT_CONFIGS, VisionTransformer
from embodied_clip_tpu_torch.models.convert import from_flax_qvit, from_flax_vit_params
from embodied_clip_tpu_torch.models.encoders import build_encoder
from embodied_clip_tpu_torch.ops.quantize_vit import DENSES, quantize_vit, quantized_vit_apply
from embodied_clip_tpu_torch.parity import cosine_distance, golden_frames

import torch_clip_cases as C
import torch_oracle as O

TINY = CLIP_VIT_CONFIGS["ViTtiny"]
NH, NL = TINY["num_heads"], TINY["layers"]


def test_configs_equal_jax():
    """Each of the JAX package's ViTs equals the port's; the port's one entry beyond them
    is ViT-L/14@336px, which the JAX package (left as it is) does not list."""
    assert {k: CLIP_VIT_CONFIGS[k] for k in JAX_VIT} == JAX_VIT
    assert set(CLIP_VIT_CONFIGS) - set(JAX_VIT) == {"ViT-L/14@336px"}


@pytest.fixture(scope="module")
def jax_encoder():
    """The JAX f32 `clip_vit_tiny` encoder, its ViT params as numpy, and frames."""
    enc = jax_build_encoder("clip_vit_tiny", dtype=jnp.float32)
    return enc, C.tree_np(dict(enc.variables["params"]["vit"])), golden_frames(8, size=96)


def _port_encoder(vit_params, dtype=torch.float32):
    enc = build_encoder("clip_vit_tiny", dtype=dtype, device="cpu")
    return enc.load_torch_state_dict({f"visual.{k}": v
                                      for k, v in from_flax_vit_params(vit_params).items()})


@torch.no_grad()
def test_vit_module_matches_jax(jax_encoder):
    _, params, _ = jax_encoder
    x = np.random.RandomState(0).randn(3, 64, 64, 3).astype(np.float32)
    cfg = {k: v for k, v in TINY.items() if k != "image_size"}
    want = np.asarray(JaxViT(**cfg).apply({"params": params}, jnp.asarray(x)))
    port = VisionTransformer(**TINY)
    port.load_state_dict(from_flax_vit_params(params))
    np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), want, atol=5e-4, rtol=5e-4)


def test_encoder_matches_jax_f32_and_bf16(jax_encoder):
    enc, params, frames = jax_encoder
    want = np.asarray(enc.encode(frames)["clip_embed"])
    port = _port_encoder(params)
    assert port.fold_bn() is port  # a ViT has no BN
    got = port.encode(frames)
    assert set(got) == {"clip_embed"} and got["clip_embed"].shape == (8, 16)
    np.testing.assert_allclose(got["clip_embed"].numpy(), want, atol=5e-4, rtol=5e-4)
    got16 = _port_encoder(params, torch.bfloat16).encode(frames)["clip_embed"]
    assert got16.dtype == torch.bfloat16
    assert cosine_distance(got16, want) <= 1e-3


@torch.no_grad()
def test_openai_layout_loads_into_the_vit():
    torch.manual_seed(3)
    oracle = O.VisionTransformerOracle(32, 16, 16, 2, 2, 8).eval()
    port = VisionTransformer(16, 16, 2, 2, 8, image_size=32)
    port.load_state_dict(oracle.state_dict())
    x = torch.randn(2, 3, 32, 32)
    torch.testing.assert_close(port(x.permute(0, 2, 3, 1)), oracle(x), atol=5e-4, rtol=5e-4)
    visual = CLIPViTVisual("ViTtiny")  # the tower the encoders build: openai's keys
    assert set(visual.state_dict()) == set(O.VisionTransformerOracle(64, 16, 32, 2, 4, 16)
                                           .state_dict())


@pytest.fixture(scope="module")
def int8_case(jax_encoder):
    """JAX's and the port's quantized towers from the same f32 weights and the same
    preprocessed calibration batch."""
    enc, params, frames = jax_encoder
    x = np.array(enc.preprocess(jnp.asarray(frames)))
    jq = C.tree_np(jax.jit(lambda p, xx: jax_quantize_vit(p, xx, NH, NL))(
        enc.variables["params"]["vit"], jnp.asarray(x)))
    pq = quantize_vit(from_flax_vit_params(params), torch.from_numpy(x), NH, NL)
    return x, jq, pq


def test_quantized_weights_and_scales_match_jax(int8_case):
    _, jq, pq = int8_case
    assert set(pq["act_scales"]) == set(jq["act_scales"]) and len(pq["act_scales"]) == 4 * NL
    for k, v in jq["act_scales"].items():
        np.testing.assert_allclose(float(pq["act_scales"][k]), float(v), rtol=1e-5, err_msg=k)
    for i in range(NL):
        for name, _, _ in DENSES:
            got, want = pq["blocks"][i][name], jq["blocks"][f"block{i}"][name]
            assert got["weight_q"].dtype == torch.int8
            np.testing.assert_array_equal(got["weight_q"].numpy(), want["kernel_q"].T)
            np.testing.assert_allclose(got["w_scale"].numpy(), want["w_scale"], rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_apply_on_jax_tree_matches_jax(int8_case, dtype):
    x, jq, _ = int8_case
    want = np.asarray(jax_qvit_apply(jax.tree.map(jnp.asarray, jq), jnp.asarray(x), NH, NL,
                                     out_dtype=getattr(jnp, dtype)), np.float32)
    got = quantized_vit_apply(from_flax_qvit(jq), torch.from_numpy(x), NH, NL,
                              out_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
    d = cosine_distance(got, want)
    max_abs = float(np.abs(got.float().numpy() - want).max())
    assert d <= 1e-3, f"cosine {d:.3e}, max abs {max_abs:.3e}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_encoder_close_to_f32(jax_encoder, dtype):
    _, params, frames = jax_encoder
    ref = _port_encoder(params).encode(frames)["clip_embed"]
    q = _port_encoder(params, getattr(torch, dtype)).quantize(frames)
    out = q.encode(frames)
    assert set(out) == {"clip_embed"} and out["clip_embed"].dtype == getattr(torch, dtype)
    assert cosine_distance(out["clip_embed"], ref) < 2e-2
    assert q.quantize(frames) is q and q.fold_bn() is q
    with pytest.raises(NotImplementedError):
        q.load_torch_state_dict({})
