"""Task and preprocessing constants; a copy of `embodied_clip_tpu/constants.py` and of
`embodied_clip_tpu/envs/thor.py:25`.

The probing vocabulary follows reference primitive_probing/constants.py:1-3 (52-object
iTHOR target vocabulary; the free-space probe head has max_forward_steps + 1 outputs).
The preprocessing sets follow reference thor_image_features.py:36-44 and the pinned
openai/CLIP preprocess.
"""

TARGET_OBJECTS = [
    'AlarmClock', 'Apple', 'ArmChair', 'Bathtub', 'Bed', 'Bowl', 'Box', 'Bread',
    'Cabinet', 'Chair', 'CoffeeMachine', 'CoffeeTable', 'Cup', 'DeskLamp',
    'DiningTable', 'Egg', 'Faucet', 'FloorLamp', 'Fridge', 'GarbageCan',
    'HandTowel', 'HousePlant', 'Laptop', 'Lettuce', 'Microwave', 'Mug',
    'Painting', 'Pan', 'Pillow', 'Plate', 'Plunger', 'Pot', 'Potato',
    'RemoteControl', 'ScrubBrush', 'SideTable', 'Sink', 'SinkBasin', 'SoapBar',
    'SoapBottle', 'Sofa', 'Spatula', 'Spoon', 'SprayBottle', 'Statue',
    'StoveBurner', 'Television', 'Toaster', 'Toilet', 'ToiletPaper', 'Tomato',
    'Towel',
]

MAX_FORWARD_STEPS = 10

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

# RoboTHOR ObjectNav target vocabulary (12 classes; allenact robothor plugin order).
ROBOTHOR_OBJECT_TYPES = [
    'AlarmClock', 'Apple', 'BaseballBat', 'BasketBall', 'Bowl', 'GarbageCan',
    'HousePlant', 'Laptop', 'Mug', 'SprayBottle', 'Television', 'Vase',
]

# Zero-shot ObjectNav split (reference readme_files/zeroshot_objectnav.md:31-32).
ZEROSHOT_SEEN_OBJECTS = [
    'AlarmClock', 'BaseballBat', 'Bowl', 'GarbageCan', 'Laptop', 'Mug',
    'SprayBottle', 'Vase',
]
ZEROSHOT_UNSEEN_OBJECTS = ['Apple', 'BasketBall', 'HousePlant', 'Television']

# THOR's discrete ObjectNav action space (the same names and indices as
# envs/gridworld.ACTIONS, so a checkpoint transfers across backends).
OBJECTNAV_ACTIONS = ("MoveAhead", "RotateLeft", "RotateRight", "LookUp", "LookDown", "End")
