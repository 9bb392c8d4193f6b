"""Work of torchvision's ResNet-50 (7x7 stem, max pool, v1.5 bottlenecks), truncated
before its pool and fc, at a configuration's published widths and declared precisions."""

from __future__ import annotations

from benchmark.work.common import BYTES, Layer, preprocess_work


def per_frame(model: dict, precision: dict):
    w, size = model["width"], model["image_size"]
    trunk = Layer()
    hw = size // 2
    trunk.conv(hw, 3, w, 7, precision["stem"])
    hw //= 2  # 3x3 stride-2 max pool
    inp, conv, short = w, precision["stage_convs"], precision["shortcut_convs"]
    for stage, blocks in enumerate(model["stage_sizes"]):
        planes = w * 2 ** stage
        for b in range(blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            trunk.conv(hw, inp, planes, 1, conv)
            hw //= stride  # the stride is on the 3x3 conv
            trunk.conv(hw, planes, planes, 3, conv)
            trunk.conv(hw, planes, planes * 4, 1, conv)
            if stride > 1 or inp != planes * 4:
                trunk.conv(hw, inp, planes * 4, 1, short)
            inp = planes * 4
    return trunk, hw, inp


def work(config: dict, batch: int, frame_hw) -> dict:
    model, precision = config["model"], config["precision"]
    size, out = model["image_size"], BYTES[precision["outputs"]]
    trunk, hw, c = per_frame(model, precision)
    t = trunk.scaled(batch)
    t["bytes"] += batch * (size * size * 3 * BYTES["bf16"] + hw * hw * c * out)
    return {"preprocess": preprocess_work(batch, frame_hw, size, "bf16"),
            f"{precision['stage_convs']}_trunk": t, "model": t}
