from embodied_clip_tpu_torch.models.clip import CLIPVisual
from embodied_clip_tpu_torch.models.clip_resnet import AttentionPool2d, ModifiedResNet
from embodied_clip_tpu_torch.models.encoders import ENCODER_SPECS, FrozenEncoder, build_encoder

__all__ = ["CLIPVisual", "AttentionPool2d", "ModifiedResNet", "ENCODER_SPECS",
           "FrozenEncoder", "build_encoder"]
