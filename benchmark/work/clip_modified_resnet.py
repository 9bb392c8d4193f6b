"""Work of CLIP's ModifiedResNet (3-conv stem, anti-aliased bottlenecks, attention
pool) at a configuration's published widths and declared precisions."""

from __future__ import annotations

from benchmark.work.common import BYTES, Layer, merge, preprocess_work


def per_frame(model: dict, precision: dict):
    """(stem + stages Layer, attention pool Layer) of one frame."""
    w, size = model["width"], model["image_size"]
    trunk, heads = Layer(), Layer()
    hw = size // 2
    trunk.conv(hw, 3, w // 2, 3, precision["stem12"], "bf16")
    trunk.conv(hw, w // 2, w // 2, 3, precision["stem12"], "bf16")
    trunk.conv(hw, w // 2, w, 3, precision["stem3"])
    hw //= 2  # the stem's 2x2 average pool
    inp, conv, short = w, precision["stage_convs"], precision["shortcut_convs"]
    for stage, blocks in enumerate(model["stage_sizes"]):
        planes = w * 2 ** stage
        for b in range(blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            trunk.conv(hw, inp, planes, 1, conv)
            trunk.conv(hw, planes, planes, 3, conv)
            hw //= stride  # an average pool before conv3 and in the shortcut
            trunk.conv(hw, planes, planes * 4, 1, conv)
            if stride > 1 or inp != planes * 4:
                trunk.conv(hw, inp, planes * 4, 1, short)
            inp = planes * 4
    tokens, c, p = hw * hw + 1, inp, precision["attnpool"]
    heads.dense(tokens, c, c, p)       # keys
    heads.dense(tokens, c, c, p)       # values
    heads.dense(1, c, c, p)            # the mean token's query
    heads.dense(1, tokens, c, p, weight_bytes=False)   # its logits over the tokens
    heads.dense(1, tokens, c, p, weight_bytes=False)   # their weighted sum of values
    heads.dense(1, c, model["output_dim"], p)          # c_proj
    return trunk, heads, hw, inp


def work(config: dict, batch: int, frame_hw) -> dict:
    model, precision = config["model"], config["precision"]
    size, out = model["image_size"], BYTES[precision["outputs"]]
    trunk, heads, hw, c = per_frame(model, precision)
    t = trunk.scaled(batch)
    t["bytes"] += batch * (size * size * 3 * BYTES["bf16"] + hw * hw * c * out)
    h = heads.scaled(batch)
    h["bytes"] += batch * (hw * hw * c + model["output_dim"]) * out
    return {"preprocess": preprocess_work(batch, frame_hw, size, "bf16"),
            f"{precision['stage_convs']}_trunk": t, "heads": h, "model": merge(t, h)}
