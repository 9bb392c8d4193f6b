"""The ViT tower (`models/clip_vit.VisionTransformer.forward`: the patch embed, the
blocks' bf16 denses on cuBLAS, the attention launch, LayerNorm and QuickGELU passes,
ln_post and the projection): the published tower's work at its declared precisions' peaks
over the device time of the kernels launched inside the span, percent."""


def read(view):
    return view.roofline("vit_trunk")
