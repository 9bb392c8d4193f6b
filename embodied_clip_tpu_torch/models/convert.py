"""Weights into the port: openai/CLIP checkpoints and the JAX package's variables.

The port's modules use openai/CLIP's state_dict names, so a reference checkpoint
loads as it is (`load_torch_checkpoint`, `visual_state_dict`). `from_flax_variables`
carries the JAX package's `{params, batch_stats}` across, inverting the layout rules of
`embodied_clip_tpu/models/convert.py:9-13`:

  flax conv kernel (kh,kw,I,O) → torch Conv2d (O,I,kh,kw)
  flax Dense kernel (I,O)      → torch Linear (O,I)
  BatchNorm scale/bias         → weight/bias; batch_stats mean/var → running_mean/var

`from_flax_resnet_variables` does the same for the JAX torchvision-style `ResNet`
(inverting `embodied_clip_tpu/models/convert.py:57-76`). `from_flax_vit_params`,
`from_flax_text_params` and `from_flax_clip_variables` invert
`embodied_clip_tpu/models/convert.py:111-180` for the ViT visual, the text tower and the
dual-tower CLIP (flax Dense kernels → (out, in); the fused in-proj kernel (C, 3C) →
`in_proj_weight` (3C, C), q-k-v rows in order; the HWIO patch embed → OIHW `conv1`;
`token_embedding.embedding` → `.weight`; LayerNorm scale/bias → weight/bias).
`from_flax_qtrunk` carries a JAX quantized trunk (`qtrunk`, CLIP or torchvision) across
as it is, in HWIO; `from_flax_qvit` a JAX quantized ViT tower into the tree of
`ops/quantize_vit.py`.
`from_flax_policy_params` carries the JAX `ActorCritic` params (or a gradient tree of
the same shape) into the port's `models/policy.ActorCritic` state_dict, and
`from_flax_allenact_params` the JAX `AllenActResnetPolicy` params into the allenact
state_dict that the port's `models/allenact_policy.AllenActResnetPolicy` loads.
`from_flax_probe_params` carries a JAX probe's params (`models/probes.py`) into the port's
probe state_dict.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["from_flax_variables", "from_flax_resnet_variables", "from_flax_vit_params",
           "from_flax_text_params", "from_flax_clip_variables", "from_flax_qtrunk",
           "from_flax_qvit", "from_flax_policy_params", "from_flax_allenact_params",
           "from_flax_probe_params", "load_torch_checkpoint", "visual_state_dict"]


def _t(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _conv_bn(sd: Dict[str, torch.Tensor], conv: str, bn: str,
             params: Mapping[str, Any], stats: Mapping[str, Any]) -> None:
    sd[f"{conv}.weight"] = _t(np.asarray(params["conv"]["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in params["conv"]:  # folded tree: BN already in the conv
        sd[f"{conv}.bias"] = _t(params["conv"]["bias"])
    if "bn" in params:
        sd[f"{bn}.weight"] = _t(params["bn"]["scale"])
        sd[f"{bn}.bias"] = _t(params["bn"]["bias"])
        sd[f"{bn}.running_mean"] = _t(stats["bn"]["mean"])
        sd[f"{bn}.running_var"] = _t(stats["bn"]["var"])
        sd[f"{bn}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def from_flax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX `CLIPVisual` (ResNet) variables, as numpy arrays → the port's state_dict.

    Takes the unfolded tree ({params, batch_stats}) or the folded one
    (conv/{kernel,bias}, no batch_stats)."""
    params = variables["params"]
    trunk = params["trunk"]
    stats = variables.get("batch_stats", {}).get("trunk", {})
    sd: Dict[str, torch.Tensor] = {}
    for i in (1, 2, 3):
        _conv_bn(sd, f"conv{i}", f"bn{i}", trunk[f"stem{i}"], stats.get(f"stem{i}", {}))
    for name, block in trunk.items():
        if not name.startswith("layer"):
            continue
        stage, b = name[len("layer"):].split("_")
        t = f"layer{stage}.{b}"
        st = stats.get(name, {})
        for ci in (1, 2, 3):
            _conv_bn(sd, f"{t}.conv{ci}", f"{t}.bn{ci}", block[f"cb{ci}"],
                     st.get(f"cb{ci}", {}))
        if "down" in block:
            _conv_bn(sd, f"{t}.downsample.0", f"{t}.downsample.1", block["down"],
                     st.get("down", {}))
    pool = params["attnpool"]
    sd["attnpool.positional_embedding"] = _t(pool["positional_embedding"])
    for proj in ("q_proj", "k_proj", "v_proj", "c_proj"):
        sd[f"attnpool.{proj}.weight"] = _t(np.asarray(pool[proj]["kernel"]).T)
        sd[f"attnpool.{proj}.bias"] = _t(pool[proj]["bias"])
    return sd


def from_flax_resnet_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX `ResNet` variables, as numpy arrays → the port's torchvision-named state_dict
    (`conv1`/`bn1`, `layerS.B.convK`/`bnK`, `downsample.0`/`.1`).

    Takes the unfolded tree ({params, batch_stats}) or the folded one."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}
    _conv_bn(sd, "conv1", "bn1", params["stem"], stats.get("stem", {}))
    for name, block in params.items():
        if not name.startswith("layer"):
            continue
        stage, b = name[len("layer"):].split("_")
        t = f"layer{stage}.{b}"
        st = stats.get(name, {})
        for conv in sorted(k for k in block if k.startswith("cb")):
            ci = conv[len("cb"):]
            _conv_bn(sd, f"{t}.conv{ci}", f"{t}.bn{ci}", block[conv], st.get(conv, {}))
        if "down" in block:
            _conv_bn(sd, f"{t}.downsample.0", f"{t}.downsample.1", block["down"],
                     st.get("down", {}))
    return sd


def _ln(sd: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any]) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _dense(sd: Dict[str, torch.Tensor], name: str, p: Mapping[str, Any]) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"], np.float32).T)
    sd[f"{name}.bias"] = _t(p["bias"])


def _transformer(sd: Dict[str, torch.Tensor], prefix: str, params: Mapping[str, Any]) -> None:
    """JAX `Transformer` params (`block{i}`) → openai's `{prefix}.resblocks.{i}.*`."""
    for name, blk in params.items():
        t = f"{prefix}.resblocks.{int(name[len('block'):])}"
        _ln(sd, f"{t}.ln_1", blk["ln_1"])
        _ln(sd, f"{t}.ln_2", blk["ln_2"])
        in_proj = blk["attn"]["in_proj"]
        sd[f"{t}.attn.in_proj_weight"] = _t(np.asarray(in_proj["kernel"], np.float32).T)
        sd[f"{t}.attn.in_proj_bias"] = _t(in_proj["bias"])
        _dense(sd, f"{t}.attn.out_proj", blk["attn"]["out_proj"])
        _dense(sd, f"{t}.mlp.c_fc", blk["mlp_fc"])
        _dense(sd, f"{t}.mlp.c_proj", blk["mlp_proj"])


def from_flax_vit_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX `VisionTransformer` params (a `CLIPVisual`'s `params["vit"]`), as numpy
    arrays → the port's ViT visual state_dict (openai's `visual.*`, prefix stripped)."""
    sd = {"conv1.weight": _t(np.asarray(params["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))}
    for name in ("class_embedding", "positional_embedding", "proj"):
        sd[name] = _t(params[name])
    _ln(sd, "ln_pre", params["ln_pre"])
    _ln(sd, "ln_post", params["ln_post"])
    _transformer(sd, "transformer", params["transformer"])
    return sd


def from_flax_text_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX `TextTransformer` params, as numpy arrays → the port's text-tower
    state_dict (openai's top-level text keys)."""
    sd = {"token_embedding.weight": _t(params["token_embedding"]["embedding"]),
          "positional_embedding": _t(params["positional_embedding"]),
          "text_projection": _t(params["text_projection"])}
    _ln(sd, "ln_final", params["ln_final"])
    _transformer(sd, "transformer", params["transformer"])
    return sd


def from_flax_clip_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX `CLIP` variables ({params: {visual, text, logit_scale}, batch_stats}), as
    numpy arrays → the port's `CLIP` state_dict: openai's full layout."""
    params = variables["params"]
    visual = params["visual"]
    if "vit" in visual:
        vis = from_flax_vit_params(visual["vit"])
    else:
        vis = from_flax_variables({"params": visual, "batch_stats":
                                   variables.get("batch_stats", {}).get("visual", {})})
    sd = from_flax_text_params(params["text"])
    sd["logit_scale"] = _t(params["logit_scale"])
    sd.update({f"visual.{k}": v for k, v in vis.items()})
    return sd


def from_flax_qvit(qtower: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX quantized ViT tower (`ops/quantize_vit.py:quantize_vit`'s tree, as numpy
    arrays) → the port's tree (`embodied_clip_tpu_torch/ops/quantize_vit.py`) on the
    CPU: `fp` in openai names, each block's s8 `weight_q` (out, in) with its `w_scale`
    and bias, `act_scales` as 0-dim f32. The bf16 attention kernels JAX keeps for its
    `ECT_VIT_QUANT_ATTN=0` option go to `fp` as the bf16 `attn.in_proj_weight` and
    `attn.out_proj.weight` (out, in) of each block, for `quant_attn=False`."""
    fp_in = qtower["fp"]
    fp = {"conv1.weight": _t(np.asarray(fp_in["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))}
    for name in ("class_embedding", "positional_embedding", "proj"):
        fp[name] = _t(fp_in[name])
    _ln(fp, "ln_pre", fp_in["ln_pre"])
    _ln(fp, "ln_post", fp_in["ln_post"])
    biases = {"in_proj": lambda b: b["attn"]["in_proj"],
              "out_proj": lambda b: b["attn"]["out_proj"],
              "mlp_fc": lambda b: b["mlp_fc"], "mlp_proj": lambda b: b["mlp_proj"]}
    blocks = []
    for i in range(len(qtower["blocks"])):
        fb = fp_in["transformer"][f"block{i}"]
        _ln(fp, f"transformer.resblocks.{i}.ln_1", fb["ln_1"])
        _ln(fp, f"transformer.resblocks.{i}.ln_2", fb["ln_2"])
        for name, key in (("in_proj", "attn.in_proj_weight"),
                          ("out_proj", "attn.out_proj.weight")):
            fp[f"transformer.resblocks.{i}.{key}"] = _t(
                np.asarray(fb["attn"][name]["kernel"], np.float32).T).to(torch.bfloat16)
        qb = qtower["blocks"][f"block{i}"]
        blocks.append({name: {"weight_q": torch.from_numpy(np.ascontiguousarray(
                                  np.asarray(qb[name]["kernel_q"], np.int8).T)),
                              "w_scale": _t(qb[name]["w_scale"]),
                              "bias": _t(get(fb)["bias"])}
                       for name, get in biases.items()})
    return {"fp": fp, "blocks": blocks,
            "act_scales": {k: _t(v).reshape(()) for k, v in qtower["act_scales"].items()}}


def from_flax_qtrunk(qtrunk: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX quantized trunk (`ops/quantize.py:quantize_trunk`'s or
    `quantize_resnet_trunk`'s tree, as numpy arrays) → the port's quantized trunk
    (`embodied_clip_tpu_torch/ops/quantize.py`) on the CPU, in the same HWIO layout: act_scales (0-dim f32), the fp stem/shortcut convs,
    and the s8 bottleneck convs with their weight scales and biases, and the s8
    stem2/stem3 copies the int8-stem option reads."""
    def t(v, dtype=np.float32):
        return torch.from_numpy(np.array(v, dtype=dtype))

    q: Dict[str, Any] = {
        "act_scales": {k: t(v).reshape(()) for k, v in qtrunk["act_scales"].items()},
        "fp": {k: {"kernel": t(v["conv"]["kernel"]), "bias": t(v["conv"]["bias"])}
               for k, v in qtrunk["fp"].items()},
    }
    for key, sub in qtrunk.items():
        if "/" in key or key in ("stem2", "stem3"):
            q[key] = {"kernel_q": t(sub["kernel_q"], np.int8), "w_scale": t(sub["w_scale"]),
                      "bias": t(sub["bias"])}
    return q


def from_flax_policy_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX `ActorCritic` params (`embodied_clip_tpu/models/policy.py`), as numpy arrays
    → the port's `ActorCritic` state_dict. Conv kernels HWIO → OIHW, Dense (in, out) →
    Linear (out, in), Embed tables as they are. The GRU, from flax's per-gate Dense
    layers to `torch.nn.GRUCell`'s packed [r; z; n] rows: weight_ih = [ir; iz; in]ᵀ,
    bias_ih = [ir.b; iz.b; in.b], weight_hh = [hr; hz; hn]ᵀ, bias_hh = [0; 0; hn.b]
    (flax's hr and hz carry no bias). A gradient tree of the params converts the same
    way."""
    sd: Dict[str, torch.Tensor] = {}

    def dense(name, p):
        sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
        sd[f"{name}.bias"] = _t(p["bias"])

    def conv(name, p):
        sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{name}.bias"] = _t(p["bias"])

    for mod, layers in (("compressor", ("reduce", "mix")), ("scratch", ("c1", "c2", "c3"))):
        for layer in layers if mod in params else ():
            conv(f"{mod}.{layer}", params[mod][layer])
    if "scratch" in params:
        dense("scratch.fc", params["scratch"]["fc"])
    for name in ("visual_fc", "goal_fc", "actor", "critic"):
        if name in params:
            dense(name, params[name])
    for name in ("goal_embed", "prev_action_embed"):
        if name in params:
            sd[f"{name}.weight"] = _t(params[name]["embedding"])
    gru = params["gru"]
    sd["gru.weight_ih"] = _t(np.concatenate([np.asarray(gru[g]["kernel"]).T
                                             for g in ("ir", "iz", "in")]))
    sd["gru.bias_ih"] = _t(np.concatenate([np.asarray(gru[g]["bias"])
                                           for g in ("ir", "iz", "in")]))
    sd["gru.weight_hh"] = _t(np.concatenate([np.asarray(gru[g]["kernel"]).T
                                             for g in ("hr", "hz", "hn")]))
    hn_b = np.asarray(gru["hn"]["bias"], np.float32)
    sd["gru.bias_hh"] = _t(np.concatenate([np.zeros(2 * hn_b.size, np.float32), hn_b]))
    return sd


def from_flax_allenact_params(params: Mapping[str, Any], grid: int = 7
                              ) -> Dict[str, torch.Tensor]:
    """JAX `AllenActResnetPolicy` params (`embodied_clip_tpu/models/allenact_policy.py`)
    → allenact's ResnetTensorNavActorCritic state_dict, inverting the JAX converter
    (`convert_allenact_state_dict`). The JAX module flattens the combiner's output in
    HWC order, allenact in CHW order: the visual columns of the GRU's input weights go
    back through `perm[hwc] = chw` (the JAX `_chw_to_hwc_perm`), the prev-action columns
    follow in order. flax's GRUCell folds allenact's two r/z biases into one, which
    lands in bias_ih (bias_hh's r/z rows are 0: the same function)."""
    pre = "goal_visual_encoder."
    sd: Dict[str, torch.Tensor] = {f"{pre}embed_goal.weight": _t(params["embed_goal"]["embedding"])}
    for name, mod in (("compress1", "resnet_compressor.0"), ("compress2", "resnet_compressor.2"),
                      ("combine1", "target_obs_combiner.0"),
                      ("combine2", "target_obs_combiner.2")):
        sd[f"{pre}{mod}.weight"] = _t(np.asarray(params[name]["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{pre}{mod}.bias"] = _t(params[name]["bias"])
    c = np.asarray(params["combine2"]["kernel"]).shape[-1]
    perm = np.arange(c * grid * grid).reshape(c, grid, grid).transpose(1, 2, 0).reshape(-1)
    gru = params["gru"]

    def input_rows(gate):
        k = np.asarray(gru[gate]["kernel"]).T  # (H, F) with the visual columns in HWC order
        w = np.empty_like(k)
        w[:, perm] = k[:, :perm.size]
        w[:, perm.size:] = k[:, perm.size:]
        return w

    rnn = "state_encoders.single_belief.rnn."
    sd[rnn + "weight_ih_l0"] = _t(np.concatenate([input_rows(g) for g in ("ir", "iz", "in")]))
    sd[rnn + "weight_hh_l0"] = _t(np.concatenate([np.asarray(gru[g]["kernel"]).T
                                                  for g in ("hr", "hz", "hn")]))
    sd[rnn + "bias_ih_l0"] = _t(np.concatenate([np.asarray(gru[g]["bias"])
                                                for g in ("ir", "iz", "in")]))
    hn_b = np.asarray(gru["hn"]["bias"], np.float32)
    sd[rnn + "bias_hh_l0"] = _t(np.concatenate([np.zeros(2 * hn_b.size, np.float32), hn_b]))
    for name, mod in (("actor", "actor.linear"), ("critic", "critic.fc")):
        sd[f"{mod}.weight"] = _t(np.asarray(params[name]["kernel"]).T)
        sd[f"{mod}.bias"] = _t(params[name]["bias"])
    if "embed_prev_action" in params:
        sd["prev_action_embedder.fc.weight"] = _t(params["embed_prev_action"]["embedding"])
    return sd


def from_flax_probe_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX probe params ({"linear"|"cell_linear": {kernel (in, out), bias}}, or a
    gradient tree of the same shape) → the port's probe state_dict
    ({name}.weight (out, in), {name}.bias)."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        _dense(sd, name, p)
    return sd


def visual_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A full openai/CLIP state_dict → its `visual.*` entries with the prefix
    stripped; a visual-only state_dict passes through."""
    if any(k.startswith("visual.") for k in sd):
        return {k[len("visual."):]: v for k, v in sd.items() if k.startswith("visual.")}
    return dict(sd)


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a .pt/.pth checkpoint on the CPU: a plain state_dict, `{"state_dict": …}`,
    or a torchscript archive (the openai CLIP release format). Floating-point
    tensors (fp16 CLIP weights included) are upcast to f32."""
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:  # not a torchscript archive
        sd = torch.load(path, map_location="cpu")
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
    return {k: (v.detach().float() if v.is_floating_point() else v.detach())
            for k, v in sd.items()}
