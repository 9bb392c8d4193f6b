from embodied_clip_tpu_torch.ops.preprocess import Preprocessor, make_preprocessor
from embodied_clip_tpu_torch.ops.resize import (
    apply_resize,
    resample_weights,
    resize_bicubic,
    resize_plan,
)

__all__ = ["Preprocessor", "make_preprocessor", "apply_resize", "resample_weights",
           "resize_bicubic", "resize_plan"]
