"""Work of each launch kind of a ResNet trunk, from a configuration's published shapes:
the pieces the program's spans time (`int8.stem`, `int8.stage1`, `int8.stride_block`,
`int8.resblocks`; `bf16.stage1`, `bf16.bottleneck`, `bf16.block`), counted as
`clip_modified_resnet.py` and `torchvision_resnet.py` count the whole trunk, so that the
kinds add up to it.

`work(config, batch, frame_hw)` gives, per kind, the operations at each declared
precision of one unit of `batch` frames and its bytes: the weights once, and each run
of consecutive blocks of the kind reading its input and writing its output once (the
activations between blocks in the stage convs' precision, the trunk's last output in the
outputs' precision). The kinds follow the trunk's path, its family and the precision of
its stage convs, as the spans that time them do: the int8 CLIP trunk's `int8_stem`
(stem1-3, `int8.stem`), `k3` (stage 1), `stride_blocks` (block 0 of each later stage) and
`k5` (the other blocks); a bf16 trunk's `bf16_stem` (CLIP's stem1-3 or torchvision's 7×7
conv, `bf16.stem`), `k7`, `bf16_stride_blocks` (`bf16.block`) and `k6`, likewise. A
family without an entry (a ViT) has no kinds.
"""

from __future__ import annotations

from benchmark.work.common import BYTES, Layer

_BF16 = ("bf16_stem", "k7", "bf16_stride_blocks", "k6")
# {work family: {stage convs' precision: (stem, stage 1, stride blocks, the rest)}}
KINDS = {"clip_modified_resnet": {"int8": ("int8_stem", "k3", "stride_blocks", "k5"),
                                  "bf16": _BF16},
         "torchvision_resnet": {"bf16": _BF16}}


def _stem(config: dict) -> Layer:
    model, precision = config["model"], config["precision"]
    w, hw = model["width"], model["image_size"] // 2
    stem = Layer()
    if config["work"] == "clip_modified_resnet":
        stem.conv(hw, 3, w // 2, 3, precision["stem12"], "bf16")
        stem.conv(hw, w // 2, w // 2, 3, precision["stem12"], "bf16")
        stem.conv(hw, w // 2, w, 3, precision["stem3"])
    else:
        stem.conv(hw, 3, w, 7, precision["stem"])
    return stem


def work(config: dict, batch: int, frame_hw) -> dict:
    model, precision = config["model"], config["precision"]
    clip = config["work"] == "clip_modified_resnet"
    stem_kind, stage1, stride_kind, identity = KINDS[config["work"]][precision["stage_convs"]]
    w, size = model["width"], model["image_size"]
    act, out = BYTES[precision["stage_convs"]], BYTES[precision["outputs"]]
    conv, short = precision["stage_convs"], precision["shortcut_convs"]
    hw = size // 4
    runs = [[stem_kind, _stem(config), size * size * 3 * BYTES["bf16"], hw * hw * w * act]]
    inp = w
    n_stages = len(model["stage_sizes"])
    for stage, blocks in enumerate(model["stage_sizes"]):
        planes = w * 2 ** stage
        for b in range(blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            kind = stage1 if stage == 0 else stride_kind if stride > 1 else identity
            if runs[-1][0] != kind:
                runs.append([kind, Layer(), hw * hw * inp * act, 0])
            layer, hw_out = runs[-1][1], hw // stride
            layer.conv(hw, inp, planes, 1, conv)
            # CLIP strides by an average pool before conv3, torchvision by the 3×3 conv.
            layer.conv(hw if clip else hw_out, planes, planes, 3, conv)
            layer.conv(hw_out, planes, planes * 4, 1, conv)
            if stride > 1 or inp != planes * 4:
                layer.conv(hw_out, inp, planes * 4, 1, short)
            last = stage == n_stages - 1 and b == blocks - 1
            runs[-1][3] = hw_out * hw_out * planes * 4 * (out if last else act)
            inp, hw = planes * 4, hw_out
    kinds = {}
    for kind, layer, in_bytes, out_bytes in runs:
        counts = layer.scaled(batch)
        counts["bytes"] += batch * (in_bytes + out_bytes)
        if kind in kinds:
            for p, v in counts["ops"].items():
                kinds[kind]["ops"][p] = kinds[kind]["ops"].get(p, 0.0) + v
            kinds[kind]["bytes"] += counts["bytes"]
        else:
            kinds[kind] = counts
    return kinds
