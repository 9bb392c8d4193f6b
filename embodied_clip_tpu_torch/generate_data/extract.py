"""Offline feature extraction from generated THOR frames (port of
`embodied_clip_tpu/generate_data/extract.py`).

Behavioral equivalent of reference generate_data/thor_image_features.py:91-140: walk
{data_dir}/{split}/*.npy scene files (the format thor_frames.py writes: per-frame dicts
with 'frame', 'semantic_frame', 'object_id_to_color', 'valid_moves_forward'), encode
every frame, compute presence/grid/free-space labels, and write one thor_{split}.npz
per split. Encoding runs in large batches on the card instead of the reference's
per-frame round trips.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Sequence

import numpy as np

from embodied_clip_tpu_torch.data.feature_store import FeatureStoreWriter

__all__ = ["extract_thor_features", "extract_reachable_features"]


def _build_encoders(encoder_names: Sequence[str], dtype: str, calibration=None,
                    device="cuda"):
    """dtype ∈ {float32, bfloat16, int8}, as the JAX package builds them: float32 and
    bfloat16 encoders unfolded (in bf16 K1 runs, and no K6/K7); int8 is the bf16 graph
    BN-folded with the PTQ int8 trunk (CLIP and torchvision ResNets, the ViT blocks),
    its activation scales calibrated on `calibration` frames (pass real data)."""
    import torch

    from embodied_clip_tpu_torch.models.encoders import build_encoder

    tdtype = torch.bfloat16 if dtype in ("bfloat16", "int8") else torch.float32
    encoders = {}
    for name in encoder_names:
        enc = build_encoder(name, dtype=tdtype, device=device)
        if dtype == "int8":
            enc = enc.fold_bn()
            if calibration is not None:
                enc = enc.quantize(calibration)
        encoders[name] = enc
    return encoders


def extract_thor_features(
    data_dir: str,
    output_dir: str,
    encoder_names: Sequence[str] = ("imagenet_rn50", "clip_rn50"),
    batch_size: int = 256,
    dtype: str = "float32",
    splits: Sequence[str] = ("train", "val", "test"),
    device="cuda",
) -> FeatureStoreWriter:
    """Write thor_{split}.npz for every split with scene files; returns the writer
    (its encoders and the last split's timing), or None if no split had frames."""
    writer = None
    for split in splits:
        frames, sems, colors, free, scenes = [], [], [], [], []
        for scene_path in sorted(glob(os.path.join(data_dir, split, "*.npy"))):
            scene_name = os.path.splitext(os.path.basename(scene_path))[0]
            for point in np.load(scene_path, allow_pickle=True):
                frames.append(point["frame"])
                sems.append(point["semantic_frame"])
                colors.append(point["object_id_to_color"])
                free.append(point["valid_moves_forward"])
                scenes.append(scene_name)
        if not frames:
            continue
        if writer is None:  # int8 calibrates on the first split's real frames
            encs = _build_encoders(encoder_names, dtype,
                                   calibration=np.stack(frames[:32]), device=device)
            writer = FeatureStoreWriter(encs, batch_size)
        writer.write_thor_split(
            output_dir, split,
            frames=np.stack(frames),
            semantic_frames=np.stack(sems),
            object_id_to_colors=colors,
            free_space=np.asarray(free),
            scenes=scenes,
        )
    return writer


def extract_reachable_features(
    data_dir: str,
    output_dir: str,
    encoder_names: Sequence[str] = ("imagenet_rn50", "clip_rn50"),
    batch_size: int = 256,
    dtype: str = "float32",
    device="cuda",
) -> None:
    """Reference generate_data/reachable_image_features.py equivalent: encode every
    CSR edge image (png) into pooled embeddings keyed by image name."""
    from PIL import Image

    images = {}
    for path in sorted(glob(os.path.join(data_dir, "*.png"))):
        name = os.path.splitext(os.path.basename(path))[0]
        images[name] = np.asarray(Image.open(path).convert("RGB"))
    calib = (np.stack(list(images.values())[:32]) if images else None)
    writer = FeatureStoreWriter(_build_encoders(encoder_names, dtype, calib, device),
                                batch_size)
    writer.write_reachable_features(output_dir, images)
