"""Fused multi-head self-attention of the CLIP transformer blocks in bf16 (the ViTs' main
path on the card).

Replaces no TPU kernel: the JAX package leaves attention to XLA, and the port's plain
route is `models/transformer.attention_core` (f32 logits materialised). The CUDA source is
`embodied_clip_tpu_torch/csrc/attention_bf16.cu`; its header notes state the bound and
the design. This module holds

  - `attention_bf16`: the wrapper. It takes the in-projection's (N, T, 3C) bf16 output as
    it lies (q, k and v by column offset) and returns the (N, T, C) bf16 input of the
    out-projection. A CUDA tensor launches the kernel (or raises); a CPU tensor, and
    only a CPU tensor, takes the plain version. `.launches` counts kernel launches;
  - `attention_plain`: the plain version, the kernel's tiling over keys and its roundings
    in torch (on any device);
  - `kernel_takes`: whether `MultiHeadAttention` hands a call to the kernel;
  - `issued_macs`, `useful_macs`: the multiply-adds a launch issues (its tiles, padding
    included) and those the attention needs, counted from the shapes.

Arithmetic (the port's precision policy, `models/transformer.py`, with an online
softmax): logits are f32 sums of bf16 products, scaled by 1/√64 (exact) in f32; keys
are walked in tiles of 64 with a running f32 row maximum m and row sum l; each tile's
probabilities exp(s - m) are f32, summed into l unrounded, and rounded to bf16 for the
p·v product, which accumulates in f32 (earlier tiles rescaled by exp(m_old - m_new));
the output is that sum over l, rounded to bf16. `attention_core` instead rounds the
normalised probabilities to bf16; both are bf16 probabilities, and
`tests/test_torch_vit_l14_336.py` holds the difference.
"""

from __future__ import annotations

import ctypes
import math

import torch

from embodied_clip_tpu_torch.ops.int8 import full_f32
from embodied_clip_tpu_torch.ops.kernels._build import Library, stream

__all__ = ["attention_bf16", "attention_plain", "kernel_takes", "issued_macs", "useful_macs",
           "HEAD_DIM", "KEY_TILE"]

HEAD_DIM = 64     # the one head width the kernel takes
KEY_TILE = 64     # keys a tile (the kernel's, and the plain version's)
GROUP_ROWS = 64   # query rows a warpgroup issues (wgmma's M)


def attention_plain(qkv: torch.Tensor, num_heads: int,
                    logits_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's function in torch: (N, T, 3C) in-projection output → (N, T, C) in its
    dtype, by key tiles of `KEY_TILE` with the online softmax of the module docstring.
    `logits_dtype` rounds each tile's scaled logits to a lower precision before the
    softmax (only to show, in a test, that the tolerances catch one); by default they
    stay f32."""
    n, t, c3 = qkv.shape
    c = c3 // 3
    d = c // num_heads
    dtype = qkv.dtype

    def heads(x):
        return x.reshape(n, t, num_heads, d).transpose(1, 2).float()

    q, k, v = (heads(x) for x in qkv.split(c, dim=-1))
    m = torch.full((n, num_heads, t), -math.inf, device=qkv.device)
    l = torch.zeros((n, num_heads, t), device=qkv.device)
    acc = torch.zeros((n, num_heads, t, d), device=qkv.device)
    with full_f32():
        for j in range(0, t, KEY_TILE):
            s = torch.matmul(q, k[:, :, j:j + KEY_TILE].transpose(-1, -2)) * (1.0 / d ** 0.5)
            s = s.to(logits_dtype).float()
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.matmul(p.to(torch.bfloat16).float(),
                                                        v[:, :, j:j + KEY_TILE])
            m = m_new
    out = (acc / l[..., None]).to(dtype)
    return out.transpose(1, 2).reshape(n, t, c)


def kernel_takes(qkv: torch.Tensor, num_heads: int, mask=None) -> bool:
    """The kernel's domain: a CUDA bf16 (N, T, 3C) contiguous, 16-byte-aligned tensor,
    heads of width 64, no mask."""
    return (qkv.is_cuda and qkv.dtype == torch.bfloat16 and mask is None and qkv.ndim == 3
            and qkv.shape[-1] == 3 * HEAD_DIM * num_heads and qkv.is_contiguous()
            and qkv.data_ptr() % 16 == 0)


def useful_macs(n: int, t: int, c: int) -> int:
    """Multiply-adds of q·kᵀ and p·v over every head: 2·T²·C a frame."""
    return 2 * n * t * t * c


def issued_macs(n: int, t: int, c: int) -> int:
    """Multiply-adds of the tiles a launch issues: every 64-row warpgroup tile holding a
    row below T, against the keys its key tiles issue (in the last tile, q·kᵀ over 16
    keys where 16 or fewer remain, else 64, and p·v in the 16-key steps that hold a key
    below T)."""
    rows = -(-t // GROUP_ROWS) * GROUP_ROWS
    full, rest = divmod(t, KEY_TILE)
    qk_keys = full * KEY_TILE + (0 if rest == 0 else 16 if rest <= 16 else KEY_TILE)
    pv_keys = full * KEY_TILE + -(-rest // 16) * 16
    return n * rows * (qk_keys + pv_keys) * c


_p, _i = ctypes.c_void_p, ctypes.c_int
LIB = Library("attention_bf16", {"ect_attention_bf16": [_p, _p, _i, _i, _i, _i, _p]})


def attention_bf16(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(N, T, 3·64·num_heads) bf16 in-projection output → (N, T, 64·num_heads) bf16, in
    one launch. A CPU tensor takes `attention_plain`."""
    if qkv.device.type == "cpu":
        return attention_plain(qkv, num_heads)
    if not kernel_takes(qkv, num_heads):
        raise ValueError(f"attention kernel expects a contiguous, 16-byte-aligned CUDA bf16 "
                         f"(N, T, {3 * HEAD_DIM * num_heads}) tensor, got {qkv.dtype} "
                         f"{tuple(qkv.shape)} on {qkv.device}")
    n, t, c3 = qkv.shape
    out = torch.empty((n, t, c3 // 3), dtype=torch.bfloat16, device=qkv.device)
    if n == 0 or t == 0:
        return out
    LIB.ect_attention_bf16(qkv.data_ptr(), out.data_ptr(), n, t, num_heads, *stream(qkv))
    attention_bf16.launches += 1
    return out


attention_bf16.launches = 0
