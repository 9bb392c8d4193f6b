"""Work of CLIP's VisionTransformer (patch embed, pre-LN blocks with QuickGELU, ln_post
and projection of the class token) at a configuration's published widths and declared
precisions.

`precision` keys: `patch_embed`, `denses` (each block's in-projection, out-projection,
c_fc and c_proj), `attention` (the two products q·kᵀ and p·v), `activations` (what q,
k, v and the attention's output are stored in), `proj` and `outputs`. ViT-L/14@336px
(width 1,024, 24 blocks of 16 heads, patch 14 at 336 px: 577 tokens, output 768) counts
190.96 GMAC a frame: the patch embed 0.347, the denses 7.260 and the attention products
0.682 a block, the projection 0.0008.

Layers of one unit of `batch` frames:
- `vit_trunk`: the patch embed, the four denses of each block, the attention products
  and the projection; bytes: the weights once, the image in and the embedding out;
- `attention`: the products q·kᵀ and p·v alone, with bytes as one fused launch moves
  them (q, k and v read once, the output written once), whatever computes them;
- `model`: the whole tower, as `vit_trunk`.
"""

from __future__ import annotations

from benchmark.work.common import BYTES, Layer, preprocess_work


def per_frame(model: dict, precision: dict):
    """(the tower Layer, the attention products' Layer, tokens) of one frame."""
    w, p, size = model["width"], model["patch_size"], model["image_size"]
    grid = size // p
    tokens = grid * grid + 1
    dense, att = precision["denses"], precision["attention"]
    trunk, attention = Layer(), Layer()
    trunk.conv(grid, 3, w, p, precision["patch_embed"])
    for _ in range(model["layers"]):
        trunk.dense(tokens, w, 3 * w, dense)      # in-projection: q, k and v
        trunk.dense(tokens, w, w, dense)          # out-projection
        trunk.dense(tokens, w, 4 * w, dense)      # c_fc
        trunk.dense(tokens, 4 * w, w, dense)      # c_proj
        for layer in (trunk, attention):
            # q·kᵀ over every head: tokens x tokens logits of head_dim products each;
            # then p·v, the same count.
            layer.dense(tokens, w, tokens, att, weight_bytes=False)
            layer.dense(tokens, tokens, w, att, weight_bytes=False)
    trunk.dense(1, w, model["output_dim"], precision["proj"])
    return trunk, attention, tokens


def work(config: dict, batch: int, frame_hw) -> dict:
    model, precision = config["model"], config["precision"]
    size = model["image_size"]
    trunk, attention, tokens = per_frame(model, precision)
    t = trunk.scaled(batch)
    t["bytes"] += batch * (size * size * 3 * BYTES["bf16"]
                           + model["output_dim"] * BYTES[precision["outputs"]])
    a = attention.scaled(batch)
    a["bytes"] = batch * model["layers"] * 4 * tokens * model["width"] * \
        BYTES[precision["activations"]]
    return {"preprocess": preprocess_work(batch, frame_hw, size, "bf16"),
            "vit_trunk": t, "attention": a, "model": t}
