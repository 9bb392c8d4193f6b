"""CLIP text tower, the source of zero-shot ObjectNav's goal embeddings (port of
`embodied_clip_tpu/models/clip_text.py`; reference readme_files/zeroshot_objectnav.md:
17-32).

Token embedding + positional embedding → causal pre-LN transformer → ln_final (f32) at
each sequence's EOT position (the argmax of the token ids: EOT is the largest id of
CLIP's vocabulary) → f32 text projection, cast to the compute dtype. The parameter names
are openai/CLIP's text half (`token_embedding`, `positional_embedding`, `transformer`,
`ln_final`, `text_projection`).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from embodied_clip_tpu_torch.models.transformer import Transformer, layer_norm_f32

__all__ = ["TextTransformer", "CLIP_TEXT_CONFIGS"]


class TextTransformer(nn.Module):
    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 512,
                 layers: int = 12, num_heads: int = 8, output_dim: int = 1024,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.token_embedding = nn.Embedding(vocab_size, width, dtype=dtype)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width,
                                                             dtype=dtype))
        self.transformer = Transformer(width, layers, num_heads, dtype)
        self.ln_final = nn.LayerNorm(width)  # f32, left in f32
        self.text_projection = nn.Parameter(torch.empty(width, output_dim))  # f32

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        """(N, T) token ids (T ≤ context_length) → (N, output_dim) in the compute dtype."""
        tokens = tokens.to(self.token_embedding.weight.device, torch.long)
        t = tokens.shape[1]
        x = self.token_embedding(tokens) + self.positional_embedding[:t]
        causal = torch.full((t, t), float("-inf"), device=x.device).triu(1)
        x = self.transformer(x, causal)
        # ln_final is per token: taking the EOT rows first computes the same values.
        x = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return torch.matmul(layer_norm_f32(x, self.ln_final),
                            self.text_projection).to(self.dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.encode_text(tokens)


CLIP_TEXT_CONFIGS = {
    "RN50": dict(width=512, layers=12, num_heads=8, output_dim=1024),
    "RN50x16": dict(width=768, layers=12, num_heads=12, output_dim=768),
    "ViT-B/32": dict(width=512, layers=12, num_heads=8, output_dim=512),
    "ViT-L/14@336px": dict(width=768, layers=12, num_heads=12, output_dim=768),
    # Smoke-scale text towers for the smoke-scale visuals (the port's CPU tests and CPU
    # runs; not paper models, and not in the JAX package's table).
    "RNtiny": dict(width=32, layers=2, num_heads=4, output_dim=16),
    "ViTtiny": dict(width=32, layers=2, num_heads=4, output_dim=16),
}
