"""CLIP transformer blocks, shared by the ViT visual tower and the text tower (port of
`embodied_clip_tpu/models/transformer.py`).

Pre-LN residual attention blocks with QuickGELU (x·σ(1.702x)) and a fused-QKV
projection, with openai/CLIP's state_dict names (`resblocks.{i}.ln_1`,
`.attn.in_proj_weight` / `.attn.in_proj_bias` (3C, C) in q-k-v order, `.attn.out_proj`,
`.ln_2`, `.mlp.c_fc`, `.mlp.c_proj`), so a release checkpoint loads with
`load_state_dict`. Tokens are (N, T, C), batch first.

The precision policy is the JAX package's, spelled out (`nn.MultiheadAttention` and
`scaled_dot_product_attention` would hide it): LayerNorm in f32, cast to the compute
dtype; the attention logits are the f32-accumulated product of the compute-dtype q·k
(the operands upcast to f32: a product of two bf16 values is exact in f32, in TF32
too), scaled, masked and softmaxed in f32, cast to the dtype, then multiplied by v with
f32 accumulation and cast; the dense layers and QuickGELU run in the compute dtype.

On the card in bf16, unmasked attention with heads of width 64 (the ViTs') runs as one
fused launch instead (`ops/kernels/attention_kernel.py`: f32 logits and softmax
statistics, the unnormalised probabilities rounded to bf16 for the p·v product); the CPU,
f32, the text tower's causal mask and the int8 ViT keep `attention_core`. The core is the
span `attn.core` either way; the launch adds the counters `attn.useful_macs` and
`attn.issued_macs` (`utils/profiling.py`).

Likewise each per-element chain of a block is one launch on the card in bf16
(`ops/kernels/pointwise_kernel.py`, where `kernel_takes`): `ln_1` with its cast, the
attention's residual add with `ln_2` and its cast, QuickGELU; elsewhere the plain chains.
The LayerNorms and QuickGELUs add their elements to the counter `pw.elements`, those on
the launches to `pw.fused_elements`.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from embodied_clip_tpu_torch.ops.kernels import attention_kernel as AK
from embodied_clip_tpu_torch.ops.kernels import pointwise_kernel as PK
from embodied_clip_tpu_torch.ops.kernels.pointwise_kernel import layer_norm_f32, quick_gelu
from embodied_clip_tpu_torch.utils.profiling import count, span

__all__ = ["quick_gelu", "attention_core", "MultiHeadAttention", "ResidualAttentionBlock",
           "Transformer", "layer_norm_f32", "layer_norm_cast", "mlp_activation"]


def layer_norm_cast(x: torch.Tensor, ln: nn.LayerNorm, dtype,
                    residual: Optional[torch.Tensor] = None):
    """`layer_norm_f32(x, ln).to(dtype)`; with `residual`, (s, that of s) for s = x +
    residual. One launch where it takes the call (bf16 on the card), else the plain
    chain."""
    count("pw.elements", x.numel())
    if dtype == torch.bfloat16 and PK.kernel_takes(x, residual, ln):
        count("pw.fused_elements", x.numel())
        return PK.layer_norm_bf16(x, ln, residual)
    return PK.layer_norm_plain(x, ln, residual, dtype)


def mlp_activation(y: torch.Tensor) -> torch.Tensor:
    """QuickGELU of the MLP's hidden tensor: one launch where it takes the call, else the
    plain chain."""
    count("pw.elements", y.numel())
    if PK.kernel_takes(y):
        count("pw.fused_elements", y.numel())
        return PK.quick_gelu_bf16(y)
    return quick_gelu(y)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                   dtype, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, T, C) q, k, v in `dtype` → (N, T, C) in `dtype`: f32-accumulated logits,
    scaled by 1/√head_dim, plus the f32 `mask`, f32 softmax cast to `dtype`, then the
    f32-accumulated product with v, cast (`transformer.py:37-49`)."""
    n, t, c = q.shape
    d = c // num_heads

    def heads(x):
        return x.reshape(n, t, num_heads, d).transpose(1, 2).float()

    logits = torch.matmul(heads(q), heads(k).transpose(-1, -2)) / (d ** 0.5)
    if mask is not None:
        logits = logits + mask.float()
    attn = logits.softmax(dim=-1).to(dtype)
    out = torch.matmul(attn.float(), heads(v))
    return out.to(dtype).transpose(1, 2).reshape(n, t, c)


class MultiHeadAttention(nn.Module):
    """`torch.nn.MultiheadAttention`'s parameters (fused in-proj, out-proj), with the
    JAX package's precision policy; the core on the fused launch where it takes the
    call (`AK.kernel_takes`)."""

    def __init__(self, width: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width, dtype=dtype))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width, dtype=dtype))
        self.out_proj = nn.Linear(width, width, dtype=dtype)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        with span("attn.core"):
            if AK.kernel_takes(qkv, self.num_heads, mask):
                n, t, c3 = qkv.shape
                count("attn.useful_macs", AK.useful_macs(n, t, c3 // 3))
                count("attn.issued_macs", AK.issued_macs(n, t, c3 // 3))
                out = AK.attention_bf16(qkv, self.num_heads)
            else:
                q, k, v = qkv.chunk(3, dim=-1)
                out = attention_core(q, k, v, self.num_heads, self.dtype, mask)
        return self.out_proj(out)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = nn.LayerNorm(width)  # f32
        self.attn = MultiHeadAttention(width, num_heads, dtype)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = nn.Sequential(OrderedDict([
            ("c_fc", nn.Linear(width, 4 * width, dtype=dtype)),
            ("c_proj", nn.Linear(4 * width, width, dtype=dtype)),
        ]))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        delta = self.attn(layer_norm_cast(x, self.ln_1, self.dtype), mask)
        x, h = layer_norm_cast(x, self.ln_2, self.dtype, residual=delta)
        return x + self.mlp.c_proj(mlp_activation(self.mlp.c_fc(h)))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, num_heads: int, dtype=torch.float32):
        super().__init__()
        self.resblocks = nn.Sequential(*[ResidualAttentionBlock(width, num_heads, dtype)
                                         for _ in range(layers)])

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x, mask)
        return x
