"""Shared cases for the CLIP transformer-family parity tests (`test_torch_clip_text.py`,
`test_torch_clip_vit.py`, `test_torch_zeroshot.py`): the JAX package's dual-tower CLIP
at the smoke-scale `ViTtiny` / `RNtiny` sizes, whose text config the JAX package's table
lacks (it is added, with the port's values, while a fixture lives), and the
conversions of its params.
"""

from __future__ import annotations

import contextlib

import numpy as np

TINY_TEXT = dict(width=32, layers=2, num_heads=4, output_dim=16)  # the port's "*tiny"


def tree_np(tree):
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    return np.array(tree)


@contextlib.contextmanager
def jax_tiny_text_configs():
    """The JAX package's `CLIP_TEXT_CONFIGS` with the port's smoke-scale text towers for
    `ViTtiny` and `RNtiny`, for the duration of the block."""
    import pytest

    from embodied_clip_tpu.models.clip_text import CLIP_TEXT_CONFIGS

    with pytest.MonkeyPatch.context() as mp:
        for name in ("ViTtiny", "RNtiny"):
            mp.setitem(CLIP_TEXT_CONFIGS, name, dict(TINY_TEXT))
        yield


def jax_clip(name: str, dtype=None, seed: int = 0):
    """The JAX package's `build_clip(name)` (f32 by default) at a smoke-scale size. Call
    it, and apply the module, inside `jax_tiny_text_configs()`: flax runs the module's
    setup, which reads the table, at every apply."""
    import jax.numpy as jnp

    from embodied_clip_tpu.models.clip import build_clip

    return build_clip(name, dtype=dtype or jnp.float32, seed=seed)


def port_clip_from_jax(built, dtype=None):
    """The port's `CLIP` of the same config holding the JAX build's weights (CPU)."""
    import torch

    from embodied_clip_tpu_torch.models.clip import CLIP
    from embodied_clip_tpu_torch.models.convert import from_flax_clip_variables

    clip = CLIP(built.module.model_name, dtype or torch.float32)
    clip.load_state_dict(from_flax_clip_variables(tree_np(dict(built.variables))))
    return clip.eval().requires_grad_(False)


def prompt_tokens(n_random: int = 3, seed: int = 0, context: int = 77):
    """Byte-level token ids (int32, (N, context)): a few real prompts, then random ids
    below EOT ending in an EOT at a random position."""
    from embodied_clip_tpu_torch.models.tokenizer import SimpleTokenizer, tokenize

    tok = SimpleTokenizer()
    toks = tokenize(["a photo of a mug.", "a photo of a basketball.", "Television"],
                    tok, context_length=context)
    rng = np.random.RandomState(seed)
    rand = np.zeros((n_random, context), np.int32)
    for i in range(n_random):
        end = rng.randint(3, context)
        rand[i, 0] = tok.sot_token
        rand[i, 1:end] = rng.randint(1, tok.sot_token, end - 1)
        rand[i, end] = tok.eot_token
    return np.concatenate([toks, rand])
