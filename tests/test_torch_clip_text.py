"""The port's tokenizer, CLIP transformer and text tower, and the dual-tower CLIP
(`embodied_clip_tpu_torch/models/{tokenizer,transformer,clip_text,clip}.py`) against the
JAX package's, on the CPU.

Tolerances:
- tokenizer: ids equal to the JAX tokenizer's (the port's is a copy; byte-level
  fallback, since the official merges file is not in the repository);
- text tower and CLIP in f32 with the JAX params carried across
  (`from_flax_clip_variables`): atol = rtol = 5e-4, the limit at which
  `tests/test_model_parity.py:101` holds the JAX text tower to openai's layout (two
  f32 implementations summing in different orders through 2 layers);
- the port's bf16 text tower within 1e-3 cosine of the JAX f32 one: the north star
  (`BASELINE.json`), bf16 rounding of 2 layers' activations;
- openai's layout (`tests/torch_oracle.py`, built on `nn.MultiheadAttention`) loads into
  the port with `load_state_dict` and agrees within 5e-4;
- EOT-position invariance within 1e-5 and logit symmetry within 1e-6, as
  `tests/test_clip_assembly.py:27-56` holds the JAX package.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from embodied_clip_tpu.models.clip_text import TextTransformer as JaxText
from embodied_clip_tpu.models.tokenizer import SimpleTokenizer as JaxTokenizer
from embodied_clip_tpu.models.tokenizer import tokenize as jax_tokenize

from embodied_clip_tpu_torch.models.clip import CLIP, build_clip
from embodied_clip_tpu_torch.models.clip_text import TextTransformer
from embodied_clip_tpu_torch.models.convert import from_flax_text_params
from embodied_clip_tpu_torch.models.tokenizer import SimpleTokenizer, tokenize
from embodied_clip_tpu_torch.parity import cosine_distance

import torch_clip_cases as C
import torch_oracle as O

TEXTS = ["a photo of a mug.", "A Photo of a SprayBottle", "  two   spaces\tand a tab ",
         "Teleport 42, then 7!", "café naïve — “quotes” ½ 日本語 🙂",
         "&amp;amp; html", "don't we'll they're it's", "x" * 40]


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_ids_equal_jax(text):
    port, ref = SimpleTokenizer(), JaxTokenizer()
    assert port.encode(text) == ref.encode(text)
    assert port.decode(port.encode(text)) == ref.decode(ref.encode(text))
    for ctx in (77, 16):
        got = tokenize([text], port, context_length=ctx, truncate=True)
        want = jax_tokenize([text], ref, context_length=ctx, truncate=True)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_tokenizer_truncation_and_merges_equal_jax():
    long = "word " * 50
    with pytest.raises(RuntimeError):
        tokenize([long], SimpleTokenizer(), context_length=8)
    merges = [("h", "e"), ("he", "l"), ("hel", "l"), ("hell", "o</w>"), ("m", "u")]
    port, ref = SimpleTokenizer(merges=merges), JaxTokenizer(merges=merges)
    for text in ("hello mug", long):
        np.testing.assert_array_equal(
            tokenize([text], port, context_length=12, truncate=True),
            jax_tokenize([text], ref, context_length=12, truncate=True))
    assert port.encoder == ref.encoder and port.vocab_size == ref.vocab_size


@pytest.fixture(scope="module")
def jax_text():
    model = JaxText(**C.TINY_TEXT)
    import jax

    tokens = C.prompt_tokens()
    variables = model.init(jax.random.PRNGKey(3), jnp.asarray(tokens))
    return model, variables, tokens


def _port_text(variables, dtype=torch.float32):
    port = TextTransformer(**C.TINY_TEXT, dtype=dtype)
    port.load_state_dict(from_flax_text_params(C.tree_np(variables["params"])))
    return port.eval()


@torch.no_grad()
def test_text_tower_matches_jax_f32_and_bf16(jax_text):
    model, variables, tokens = jax_text
    want = np.asarray(model.apply(variables, jnp.asarray(tokens)))
    got = _port_text(variables)(torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == (len(tokens), 16)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=5e-4)
    got16 = _port_text(variables, torch.bfloat16)(torch.from_numpy(tokens))
    assert got16.dtype == torch.bfloat16
    assert cosine_distance(got16, want) <= 1e-3


@torch.no_grad()
def test_text_tower_bf16_matches_jax_bf16(jax_text):
    """The same bf16 policy in both packages: the two bf16 towers within 1e-3 cosine."""
    _, variables, tokens = jax_text
    want = JaxText(**C.TINY_TEXT, dtype=jnp.bfloat16).apply(variables, jnp.asarray(tokens))
    got = _port_text(variables, torch.bfloat16)(torch.from_numpy(tokens))
    assert cosine_distance(got, np.asarray(want, np.float32)) <= 1e-3


@torch.no_grad()
def test_openai_layout_loads_into_the_text_tower():
    torch.manual_seed(2)
    oracle = O.TextTransformerOracle(600, 12, 16, 2, 2, 8).eval()
    port = TextTransformer(600, 12, 16, 2, 2, 8)
    port.load_state_dict(oracle.state_dict())
    tokens = torch.randint(0, 600, (3, 12))
    torch.testing.assert_close(port(tokens), oracle(tokens), atol=5e-4, rtol=5e-4)


@torch.no_grad()
def test_encode_text_eot_position_invariance():
    """Features come from the EOT position: changing the ids after it (below EOT, so
    argmax still finds it) leaves the embedding as it was, through the causal mask."""
    torch.manual_seed(0)
    model = TextTransformer(vocab_size=64, context_length=16, width=16, layers=1,
                            num_heads=2, output_dim=8)
    from embodied_clip_tpu_torch.models.clip import init_weights_

    init_weights_(model, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(2)
    toks = np.zeros((1, 16), np.int64)
    toks[0, 0] = 60
    toks[0, 1:4] = rng.randint(1, 50, 3)
    toks[0, 4] = 63
    toks2 = toks.copy()
    toks2[0, 5:] = rng.randint(1, 50, 11)
    a, b = model(torch.from_numpy(toks)), model(torch.from_numpy(toks2))
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


@torch.no_grad()
@pytest.mark.parametrize("name", ["ViTtiny", "RNtiny"])
def test_clip_logits_symmetric_and_scaled(name):
    clip = build_clip(name, device="cpu")
    size = 64 if name == "ViTtiny" else 128
    imgs = torch.from_numpy(np.random.RandomState(0).rand(3, size, size, 3).astype(np.float32))
    li, lt = clip(imgs, torch.from_numpy(C.prompt_tokens(1)))
    assert li.shape == (3, 4) and lt.shape == (4, 3) and li.dtype == torch.float32
    torch.testing.assert_close(li, lt.t(), atol=1e-6, rtol=0)
    assert float(li.abs().max()) <= float(clip.logit_scale.exp()) + 1e-4
    assert abs(float(clip.logit_scale) - np.log(1 / 0.07)) < 1e-6


def test_clip_state_dict_is_openai_layout():
    """The dual tower's keys are the full release's: the text tower's at top level,
    the visual tower's under `visual.*` (openai's oracles' keys), and `logit_scale`."""
    clip = CLIP("ViTtiny")
    text = O.TextTransformerOracle(49408, 77, 32, 2, 4, 16).state_dict()
    vit = O.VisionTransformerOracle(64, 16, 32, 2, 4, 16).state_dict()
    want = set(text) | {f"visual.{k}" for k in vit} | {"logit_scale"}
    assert set(clip.state_dict()) == want
    for k, v in {**text, **{f"visual.{k}": v for k, v in vit.items()}}.items():
        assert clip.state_dict()[k].shape == v.shape, k


@pytest.fixture(scope="module", params=["ViTtiny", "RNtiny"])
def clip_pair(request):
    with C.jax_tiny_text_configs():
        built = C.jax_clip(request.param)
        yield built, C.port_clip_from_jax(built)


@torch.no_grad()
def test_clip_matches_jax(clip_pair):
    """encode_text, encode_image and both logit matrices of the JAX CLIP's weights
    carried across, f32."""
    built, port = clip_pair
    size = 64 if built.module.model_name == "ViTtiny" else 128
    imgs = np.random.RandomState(1).rand(2, size, size, 3).astype(np.float32)
    tokens = C.prompt_tokens(2)
    want_t = built.module.apply(built.variables, jnp.asarray(tokens), method="encode_text")
    want_i = built.module.apply(built.variables, jnp.asarray(imgs), method="encode_image")
    want_li, want_lt = built.module.apply(built.variables, jnp.asarray(imgs),
                                          jnp.asarray(tokens))
    got_li, got_lt = port(torch.from_numpy(imgs), torch.from_numpy(tokens))
    np.testing.assert_allclose(port.encode_text(torch.from_numpy(tokens)).numpy(),
                               np.asarray(want_t), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(port.encode_image(torch.from_numpy(imgs)).numpy(),
                               np.asarray(want_i), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(got_li.numpy(), np.asarray(want_li), atol=5e-4, rtol=5e-4)
    np.testing.assert_allclose(got_lt.numpy(), np.asarray(want_lt), atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("name,encoder", [("RNtiny", "clip_rn_tiny"),
                                          ("ViTtiny", "clip_vit_tiny")])
def test_build_clip_visual_holds_the_encoders_weights(name, encoder):
    """One seed, one set of visual weights: `build_clip`'s tower, `build_visual`'s and
    `build_encoder`'s, in bf16 as in f32 (the weights drawn once in f32 on the CPU)."""
    from embodied_clip_tpu_torch.models.clip import build_visual
    from embodied_clip_tpu_torch.models.encoders import build_encoder

    enc = build_encoder(encoder, seed=4, device="cpu").module.state_dict()
    for vis in (build_clip(name, seed=4, device="cpu").visual,
                build_visual(name, seed=4, device="cpu")):
        assert all(torch.equal(v, vis.state_dict()[k]) for k, v in enc.items())
    vis16 = build_visual(name, torch.bfloat16, seed=4, device="cpu").state_dict()
    assert all(torch.equal(v.to(vis16[k].dtype), vis16[k]) for k, v in enc.items())
