"""The system under test, built through its public entries only, as its users build
it: `build_encoder` -> `load_torch_state_dict` -> `fold_bn` -> `quantize`, from a
configuration file's `program` section (data, so a new configuration needs no code).

`program` keys: `encoder` (an `ENCODER_SPECS` name), `dtype`, `fold_bn`, `quantize`
(calibrate the int8 trunk on the configuration's calibration frames), `kernels`
(keywords of the int8 encoder's `with_kernels`). The `control` section holds the same
keys for the program's own lower-precision path, which the limits are set against.
"""

from __future__ import annotations

import torch


def build_encoder(program: dict, state_dict, calibration, device):
    from embodied_clip_tpu_torch.models.encoders import build_encoder as build

    enc = build(program["encoder"], getattr(torch, program["dtype"]), device=device)
    enc.load_torch_state_dict(state_dict)
    if program.get("fold_bn"):
        enc = enc.fold_bn()
    if program.get("quantize"):
        enc = enc.quantize(calibration)
    if program.get("kernels"):
        enc = enc.with_kernels(**program["kernels"])
    return enc


def program_section(config: dict, control: bool = False) -> dict:
    """The `program` section, with the `control` section laid over it when asked."""
    return {**config["program"], **(config["control"] if control else {})}
