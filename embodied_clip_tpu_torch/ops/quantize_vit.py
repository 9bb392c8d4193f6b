"""Post-training int8 quantization of the frozen CLIP ViT tower, inference only (port of
`embodied_clip_tpu/ops/quantize_vit.py`).

The four dense layers of every transformer block (the fused-QKV in-proj, out-proj,
mlp c_fc, mlp c_proj) carry ~98% of ViT-B/32's operations: at batch 128 they are
(6400, 768) × (768, 2304 | 768 | 3072) and (6400, 3072) × (3072, 768) products, which
run s8 × s8 → s32 through `ops/int8.qmm` (`torch._int_mm`). Everything
fidelity-critical stays high-precision: LayerNorms (f32), the attention core (the
policy of `models/transformer.py`), QuickGELU (in f32 here, where the fp tower runs it
in the compute dtype), the residual stream (compute dtype), the patch embed, ln_pre,
ln_post and the f32 projection.

Scheme (symmetric PTQ, as the ResNet trunk's):
  weights      s8 per output channel, scale = max|w| / 127 + 1e-30
  activations  s8 per tensor, SIGNED (LayerNorm, attention and GELU outputs span both
               signs), scale = max|x| / 127 + 1e-30 over the calibration batch in the
               f32 forward; requantised with `ops/int8.requant_signed`
  epilogue     acc.f32 · (a_scale · w_scale) + bias, the reference's order
               (`quantize_vit.py:138-140`)

The serving tree: `fp` (the f32 state_dict entries of everything that is not one of
the four denses, openai names, plus each block's attention in-proj and out-proj weights
(out, in) in bf16, as the JAX package keeps them), `blocks` (one dict per block: each
dense's `weight_q` (out, in) s8 — the torch Linear layout, whose transpose is the
column-major operand `qmm` takes as it is — its `w_scale` and f32 `bias`), and
`act_scales` (0-dim f32 tensors on the data's device, keyed as in the JAX package:
`block{i}/attn_in`, `/attn_out_in`, `/mlp_in`, `/mlp_proj_in`).

`quantized_vit_apply` takes the JAX package's trace-time options as keywords
(`quantize_vit.py:105-140,241-261`), defaulting as JAX does:
  quant_attn     (ECT_VIT_QUANT_ATTN)  False: the in-proj and out-proj as products of
                                       bf16 operands with f32 sums, plus the f32 bias
  recip_requant  (ECT_RECIP_REQUANT=1) the reciprocal requant (`ops/int8.py`)
The JAX package's `ECT_VIT_CONV_OUT=1` only picks XLA's conv emitter for the out-proj's
s8 product over its dot emitter: the product is integer-exact either way, so its output
is bit-equal to the default's, and the port has the one s8 GEMM.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from embodied_clip_tpu_torch.models.clip_vit import patch_embed
from embodied_clip_tpu_torch.models.transformer import attention_core, quick_gelu
from embodied_clip_tpu_torch.ops.int8 import QMAX, full_f32, qmm, requant_signed

__all__ = ["quantize_vit", "quantized_vit_apply", "DENSES"]

# The block's four denses: (name in the JAX tree, its act-scale key, openai prefix).
DENSES = (("in_proj", "attn_in", "attn.in_proj_"), ("out_proj", "attn_out_in", "attn.out_proj."),
          ("mlp_fc", "mlp_in", "mlp.c_fc."), ("mlp_proj", "mlp_proj_in", "mlp.c_proj."))
# The denses `quant_attn=False` runs from bf16 weights kept in `fp`.
ATTN_DENSES = ("in_proj", "out_proj")


def _dense_keys(i: int, prefix: str):
    """(weight key, bias key) of one dense of block i in openai's names."""
    t = f"transformer.resblocks.{i}.{prefix}"
    return t + "weight", t + "bias"


def _ln(x: torch.Tensor, sd: Dict[str, torch.Tensor], name: str,
        eps: float = 1e-5) -> torch.Tensor:
    """f32 LayerNorm over the last axis."""
    w = sd[name + ".weight"]
    return F.layer_norm(x.float(), w.shape, w, sd[name + ".bias"], eps)


def _forward(fp: Dict[str, torch.Tensor], x: torch.Tensor, num_heads: int, layers: int,
             dtype, dense: Callable[[int, str, torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """The ViT forward skeleton (`quantize_vit.py:79-181`) in compute dtype `dtype`;
    `dense(i, name, t)` computes block i's dense `name` on `t` and returns f32."""
    x = patch_embed(x.to(dtype), fp["conv1.weight"].to(dtype))
    cls = fp["class_embedding"].to(dtype).expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + fp["positional_embedding"].to(dtype)
    x = _ln(x, fp, "ln_pre").to(dtype)
    for i in range(layers):
        blk = f"transformer.resblocks.{i}"
        y = _ln(x, fp, blk + ".ln_1").to(dtype)
        q, k, v = dense(i, "in_proj", y).to(dtype).chunk(3, dim=-1)
        o = dense(i, "out_proj", attention_core(q, k, v, num_heads, dtype))
        x = x + o.to(dtype)
        y = dense(i, "mlp_fc", _ln(x, fp, blk + ".ln_2").to(dtype))
        y = dense(i, "mlp_proj", quick_gelu(y.float()).to(dtype))
        x = x + y.to(dtype)
    return torch.matmul(_ln(x[:, 0], fp, "ln_post"), fp["proj"].float())


def _quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric s8 of a Linear weight (out, in)."""
    w = w.float()
    scale = w.abs().amax(dim=1) / QMAX + 1e-30
    q = torch.clamp(torch.round(w / scale[:, None]), -QMAX, QMAX).to(torch.int8)
    return {"weight_q": q.contiguous(), "w_scale": scale}


def quantize_vit(sd: Dict[str, torch.Tensor], x_calib: torch.Tensor, num_heads: int,
                 layers: int) -> Dict[str, Any]:
    """Calibrate and quantize the ViT tower. `sd` is the tower's state_dict (openai
    names, `visual.*` stripped; upcast to f32 here) and `x_calib` a PREPROCESSED batch
    of representative frames (real frames, never noise: per-tensor maxima on noise clip
    natural images). Calibration runs the f32 forward with TF32 off."""
    sd = {k: v.float() for k, v in sd.items()}
    dense_w = {i: {name: _dense_keys(i, prefix) for name, _, prefix in DENSES}
               for i in range(layers)}
    act_key = {name: key for name, key, _ in DENSES}
    scales: Dict[str, torch.Tensor] = {}

    def collect(i, name, t):
        t = t.float()
        scales[f"block{i}/{act_key[name]}"] = t.abs().amax() / QMAX + 1e-30
        w, b = dense_w[i][name]
        return torch.matmul(t, sd[w].t()) + sd[b]

    with full_f32():
        _forward(sd, x_calib, num_heads, layers, torch.float32, collect)
    blocks = [{name: {**_quantize_weight(sd[w]), "bias": sd[b]}
               for name, (w, b) in dense_w[i].items()} for i in range(layers)]
    dense_keys = {k for i in dense_w for pair in dense_w[i].values() for k in pair}
    fp = {k: v for k, v in sd.items() if k not in dense_keys}
    for i in dense_w:
        for name in ATTN_DENSES:
            w = dense_w[i][name][0]
            fp[w] = sd[w].to(torch.bfloat16)
    return {"fp": fp, "blocks": blocks, "act_scales": scales}


def quantized_vit_apply(q: Dict[str, Any], x: torch.Tensor, num_heads: int, layers: int,
                        out_dtype=torch.bfloat16, quant_attn: bool = True,
                        recip_requant: bool = False) -> torch.Tensor:
    """int8 ViT forward: x is the preprocessed NHWC image batch (f32/bf16). Returns the
    CLIP embedding in `out_dtype`, which is also the compute dtype of the residual
    stream and the attention core. `quant_attn` and `recip_requant` are the options of
    the module docstring."""
    key = {name: key for name, key, _ in DENSES}
    prefix = {name: p for name, _, p in DENSES}

    def dense(i, name, t):
        d = q["blocks"][i][name]
        if not quant_attn and name in ATTN_DENSES:
            w = q["fp"][_dense_keys(i, prefix[name])[0]]
            with full_f32():
                y = torch.matmul(t.to(out_dtype).float(), w.to(out_dtype).float().t())
            return y + d["bias"]
        a = q["act_scales"][f"block{i}/{key[name]}"]
        t8 = requant_signed(t.float(), a, recip_requant)
        acc = qmm(t8.reshape(-1, t8.shape[-1]), d["weight_q"].t())
        y = acc.float() * (a * d["w_scale"]) + d["bias"]
        return y.reshape(*t.shape[:-1], -1)

    return _forward(q["fp"], x, num_heads, layers, out_dtype, dense).to(out_dtype)
