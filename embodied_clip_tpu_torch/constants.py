"""Preprocessing constant sets (reference thor_image_features.py:36-44 and the pinned
openai/CLIP preprocess); a copy of `embodied_clip_tpu/constants.py:21-26`."""

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
