from embodied_clip_tpu_torch.models.clip import CLIP, CLIPViTVisual, CLIPVisual, build_clip
from embodied_clip_tpu_torch.models.clip_resnet import AttentionPool2d, ModifiedResNet
from embodied_clip_tpu_torch.models.encoders import ENCODER_SPECS, FrozenEncoder, build_encoder

__all__ = ["CLIP", "CLIPViTVisual", "build_clip", "CLIPVisual", "AttentionPool2d",
           "ModifiedResNet", "ENCODER_SPECS", "FrozenEncoder", "build_encoder"]
