"""THOR frame-dataset generator (a copy of
`embodied_clip_tpu/generate_data/thor_frames.py`; behavioral port of the reference
pipeline).

Reproduces generate_data/thor_frames.py's behavior: drive AI2-THOR over all iTHOR
scenes excluding bathrooms; split by scene id (id%100 ≤20 train, ≤25 val, else test,
reference :43-49); per accepted pose record RGB/depth/semantic/instance frames +
object metadata; rejection-sample poses (≤4 tries) until ≥1.5% of pixels belong to
target objects (:62-82); measure ground-truth free space by stepping MoveAhead until
failure (:84-86); 100 train / 50 val/test frames per scene (:58); save per-scene .npy
dicts consumed by generate_data/extract.py.

Host-only code (simulator IPC-bound); requires ai2thor. Exposed on the CLI as
`python -m embodied_clip_tpu_torch.generate_data.thor_frames`.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np

from embodied_clip_tpu_torch.constants import TARGET_OBJECTS

CAMERA = dict(
    gridSize=0.25,
    makeAgentsVisible=False,
    rotateStepDegrees=90,
    renderDepthImage=True,
    renderSemanticSegmentation=True,
    renderInstanceSegmentation=True,
    quality="High",
    width=300,
    height=300,
    fieldOfView=90,
)
ROTATIONS = (0, 90, 180, 270)
HORIZONS = (45,)
MIN_OBJECT_PIXEL_FRACTION = 0.015
MAX_POSE_TRIES = 4
FRAMES_PER_SCENE = {"train": 100, "val": 50, "test": 50}


def split_of_scene(scene_name: str) -> str:
    scene_id = int(scene_name.replace("FloorPlan", "").replace("_physics", ""))
    r = scene_id % 100
    if r <= 20:
        return "train"
    if r <= 25:
        return "val"
    return "test"


def _object_pixel_fraction(event) -> float:
    masks = [v for k, v in event.class_masks.items() if k in TARGET_OBJECTS]
    if not masks:
        return 0.0
    union = np.any(masks, axis=0)
    return float(union.sum()) / float(np.prod(union.shape))


def _count_free_steps(controller) -> int:
    moves = 0
    while controller.step("MoveAhead").metadata["lastActionSuccess"]:
        moves += 1
    return moves


def generate(output_dir: str, seed: int = 0, scenes=None) -> None:
    from ai2thor.controller import Controller

    rng = random.Random(seed)
    for split in FRAMES_PER_SCENE:
        os.makedirs(os.path.join(output_dir, split), exist_ok=True)

    controller = Controller(**CAMERA)
    scene_list = scenes or controller.ithor_scenes(include_bathrooms=False)

    for scene_name in scene_list:
        split = split_of_scene(scene_name)
        controller.reset(scene=scene_name)
        controller.step(action="GetReachablePositions")
        locations = list(controller.last_event.metadata["actionReturn"])

        records = []
        # Bound total sampling so a scene where no pose ever clears the pixel
        # fraction (no visible target objects) cannot hang the whole run — we
        # warn and move on with whatever was collected.
        attempts_left = 200 * FRAMES_PER_SCENE[split]
        while len(records) < FRAMES_PER_SCENE[split] and attempts_left > 0:
            attempts_left -= 1
            pos = rng.choice(locations)
            event = None
            for _ in range(MAX_POSE_TRIES):
                rot = rng.choice(ROTATIONS)
                hor = rng.choice(HORIZONS)
                event = controller.step(
                    action="TeleportFull",
                    position=pos,
                    rotation=dict(x=0, y=rot, z=0),
                    horizon=hor,
                    standing=True,
                )
                if _object_pixel_fraction(event) > MIN_OBJECT_PIXEL_FRACTION:
                    break
            else:
                continue  # pose rejected after all tries; resample position

            records.append({
                "agent_metadata": {
                    "position": pos,
                    "rotation": dict(x=0, y=rot, z=0),
                    "horizon": hor,
                    "standing": True,
                },
                "object_metadata": event.metadata["objects"],
                "frame": event.frame,
                "depth_frame": event.depth_frame,
                "semantic_frame": event.semantic_segmentation_frame,
                "instance_frame": event.instance_segmentation_frame,
                "object_id_to_color": event.object_id_to_color,
                "valid_moves_forward": _count_free_steps(controller),
            })

        if len(records) < FRAMES_PER_SCENE[split]:
            print(f"WARNING: {scene_name}: only {len(records)}/"
                  f"{FRAMES_PER_SCENE[split]} poses cleared the "
                  f"{MIN_OBJECT_PIXEL_FRACTION:.3f} pixel-fraction filter "
                  "within the attempt budget; saving the partial scene")
        np.save(os.path.join(output_dir, split, f"{scene_name}.npy"), records)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--output_dir", default="data/ithor_scenes")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    generate(args.output_dir, args.seed)
