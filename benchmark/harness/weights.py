"""Seeded weights, made on the device in a few large calls.

The distributions are a frozen copy of the port's `models/clip.init_weights_` and
`models/policy.ActorCritic.init_weights` (flax's defaults: conv, dense and GRU input
kernels truncated LeCun-normal, the attention's fused in-projection as a dense of
fan-in width, embeddings, the positional embeddings, a ViT's class embedding and
projection N(0, 1/width), GRU biases zero), with three departures. The GRU's recurrent
kernel is truncated LeCun-normal rather than orthogonal. So that the folding of batch
norm, the affine of layer norm and every bias are exercised rather than multiplied by
one and added as zero, batch norm's and layer norm's scales and batch norm's variance
are U(0.9, 1.1), their shifts and batch norm's mean N(0, 0.05^2), and conv, dense and
in-projection biases N(0, 0.02^2), as in a trained network.

A module draws only for the parameters it holds, in module order, so adding a kind of
module leaves every draw of a model without it bit-identical.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

_TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated to +-2
_PHI_2 = 0.022750131948179195     # P(Z < -2)
BN_SPREAD, BN_SHIFT, BIAS_STD = 0.1, 0.05, 0.02


def _plan(module: nn.Module):
    """[(tensor, kind, a, b)]: kind 'trunc' (std a), 'normal' (mean a, std b),
    'uniform' (low a, high b) or 'zero', in module order."""
    out = []
    for mod in module.modules():
        own = dict(mod.named_parameters(recurse=False))
        own.update(dict(mod.named_buffers(recurse=False)))
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            fan_in = mod.weight[0].numel()
            out.append((mod.weight, "trunc", (1.0 / fan_in) ** 0.5 / _TRUNC_STD, 0.0))
            if mod.bias is not None:
                out.append((mod.bias, "normal", 0.0, BIAS_STD))
        elif isinstance(mod, nn.BatchNorm2d):
            out += [(mod.weight, "uniform", 1 - BN_SPREAD, 1 + BN_SPREAD),
                    (mod.bias, "normal", 0.0, BN_SHIFT),
                    (mod.running_mean, "normal", 0.0, BN_SHIFT),
                    (mod.running_var, "uniform", 1 - BN_SPREAD, 1 + BN_SPREAD),
                    (mod.num_batches_tracked, "zero", 0, 0)]
        elif isinstance(mod, nn.Embedding):
            out.append((mod.weight, "normal", 0.0, mod.weight.shape[1] ** -0.5))
        elif isinstance(mod, nn.GRUCell):
            # Zero biases, as at initialisation: the recurrent r and z biases are not
            # parameters of the published cell and must stay zero.
            out += [(mod.weight_ih, "trunc", (1.0 / mod.input_size) ** 0.5 / _TRUNC_STD, 0.0),
                    (mod.weight_hh, "trunc", (1.0 / mod.hidden_size) ** 0.5 / _TRUNC_STD, 0.0),
                    (mod.bias_ih, "zero", 0, 0), (mod.bias_hh, "zero", 0, 0)]
        elif isinstance(mod, nn.LayerNorm):
            out += [(mod.weight, "uniform", 1 - BN_SPREAD, 1 + BN_SPREAD),
                    (mod.bias, "normal", 0.0, BN_SHIFT)]
        elif "in_proj_weight" in own:
            w = own["in_proj_weight"]   # (3 width, width): q, k and v of one input
            out += [(w, "trunc", (1.0 / w.shape[1]) ** 0.5 / _TRUNC_STD, 0.0),
                    (own["in_proj_bias"], "normal", 0.0, BIAS_STD)]
        else:
            # Free parameters of the module that owns them, N(0, 1/width): the
            # positional embedding (tokens, width), the class embedding (width,) and
            # the projection (width, output).
            for name, width_axis in (("positional_embedding", -1), ("class_embedding", -1),
                                     ("proj", 0)):
                if name in own:
                    t = own[name]
                    out.append((t, "normal", 0.0, t.shape[width_axis] ** -0.5))
    return out


@torch.no_grad()
def fill_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every parameter and buffer of `module` (already on the generator's device)
    from `generator`: one draw per distribution for the whole module."""
    plan = _plan(module)
    covered = {id(t) for t, *_ in plan}
    missing = [n for n, t in list(module.named_parameters()) + list(module.named_buffers())
               if id(t) not in covered]
    if missing:
        raise ValueError(f"no distribution for {missing}")
    dev = generator.device
    sizes = {k: sum(t.numel() for t, kind, *_ in plan if kind == k)
             for k in ("trunc", "normal", "uniform")}
    flat = {k: torch.empty(n, device=dev) for k, n in sizes.items()}
    flat["trunc"].uniform_(_PHI_2, 1 - _PHI_2, generator=generator)
    flat["trunc"] = torch.erfinv(flat["trunc"].mul_(2).sub_(1)).mul_(math.sqrt(2.0))
    flat["normal"].normal_(generator=generator)
    flat["uniform"].uniform_(generator=generator)
    offset = dict.fromkeys(flat, 0)
    for t, kind, a, b in plan:
        if kind == "zero":
            t.zero_()
            continue
        o, n = offset[kind], t.numel()
        v = flat[kind][o:o + n].view(t.shape)
        offset[kind] = o + n
        if kind == "trunc":
            t.copy_(v * a)
        elif kind == "normal":
            t.copy_(v * b + a)
        else:
            t.copy_(v * (b - a) + a)
    return module


def seeded_generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one named use of the run's seed."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + stream) % (2 ** 63))
