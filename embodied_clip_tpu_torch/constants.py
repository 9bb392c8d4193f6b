"""Task and preprocessing constants; a copy of `embodied_clip_tpu/constants.py:21-34` and
of `embodied_clip_tpu/envs/thor.py:25`.

The preprocessing sets follow reference thor_image_features.py:36-44 and the pinned
openai/CLIP preprocess.
"""

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# RoboTHOR ObjectNav target vocabulary (12 classes; allenact robothor plugin order).
ROBOTHOR_OBJECT_TYPES = [
    'AlarmClock', 'Apple', 'BaseballBat', 'BasketBall', 'Bowl', 'GarbageCan',
    'HousePlant', 'Laptop', 'Mug', 'SprayBottle', 'Television', 'Vase',
]

# THOR's discrete ObjectNav action space (the same names and indices as
# envs/gridworld.ACTIONS, so a checkpoint transfers across backends).
OBJECTNAV_ACTIONS = ("MoveAhead", "RotateLeft", "RotateRight", "LookUp", "LookDown", "End")
