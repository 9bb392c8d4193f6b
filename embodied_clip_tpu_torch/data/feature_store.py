"""Offline feature-store writer: batched encode of simulator frames on the card (port of
`embodied_clip_tpu/data/feature_store.py`).

Replaces the reference's extraction scripts (thor_image_features.py:91-140,
reachable_image_features.py:77-100), which run batch-size-1 host↔device round trips per
frame: here uint8 frames go to the card in large batches, each encoder computes all its
keys in one pass, and the labels (object presence / 3×3 grid presence / free space) are
computed vectorized on the host from semantic frames.

Output: thor_{split}.npz per split + reachable_image_features.npz /
reachable_{split}.json, the formats data/probing.py reads; conv maps NHWC, features f32.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch

from embodied_clip_tpu_torch.constants import TARGET_OBJECTS

__all__ = ["FeatureStoreWriter", "class_masks", "presence_labels", "grid_presence_labels",
           "frame_labels"]


def _packed(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) channels in [0, 255] → one int32 per pixel (r·2¹⁶ + g·2⁸ + b)."""
    rgb = rgb.astype(np.int32)
    return (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]


def class_masks(semantic_frame: np.ndarray, object_id_to_color: Mapping[str, Sequence[int]],
                objects: Sequence[str] = tuple(TARGET_OBJECTS)) -> np.ndarray:
    """(num_objects, H, W) bool masks — vectorized over all classes at once
    (reference computes one class at a time, thor_image_features.py:71-75/115-120)."""
    colors = np.zeros((len(objects), 3), dtype=np.int32)
    valid = np.zeros(len(objects), dtype=bool)
    for i, o in enumerate(objects):
        c = object_id_to_color.get(o)
        if c is not None:
            colors[i] = np.asarray(c, dtype=np.int32)
            valid[i] = True
    eq = (semantic_frame[None].astype(np.int32) == colors[:, None, None, :]).all(axis=-1)
    return eq & valid[:, None, None]


def presence_labels(masks: np.ndarray) -> np.ndarray:
    """(num_objects,) int — any pixel present (thor_image_features.py:77-78,122)."""
    return (masks.sum(axis=(1, 2)) > 0).astype(np.int64)


def grid_presence_labels(masks: np.ndarray, grid=(3, 3)) -> np.ndarray:
    """(grid_cells, num_objects) int — per-cell presence with the reference's integer
    box edges (thor_image_features.py:80-88,123-127)."""
    h, w = masks.shape[1:3]
    out = []
    for i in range(grid[0]):
        for j in range(grid[1]):
            y1, y2 = int(i * h / grid[0]), int((i + 1) * h / grid[0])
            x1, x2 = int(j * w / grid[1]), int((j + 1) * w / grid[1])
            out.append(presence_labels(masks[:, y1:y2, x1:x2]))
    return np.stack(out)


def frame_labels(semantic_frame: np.ndarray, object_id_to_color: Mapping[str, Sequence[int]],
                 objects: Sequence[str] = tuple(TARGET_OBJECTS), grid=(3, 3)):
    """(`presence_labels`, `grid_presence_labels`) of `class_masks(semantic_frame, …)`.
    A uint8 frame (THOR's) with colours in [0, 255] takes the colours present in the
    frame and in each cell, packed one int32 a pixel, and no per-class masks: an order
    of magnitude less host time; any other takes the masks."""
    colors = [object_id_to_color.get(o) for o in objects]
    valid = np.array([c is not None for c in colors])
    rgb = np.array([c if c is not None else (0, 0, 0) for c in colors], np.int64).reshape(-1, 3)
    sem = semantic_frame[..., :3]
    if sem.dtype != np.uint8 or rgb.min() < 0 or rgb.max() > 255:
        m = class_masks(semantic_frame, object_id_to_color, objects)
        return presence_labels(m), grid_presence_labels(m, grid)
    packed, cp = _packed(sem), _packed(rgb)
    h, w = packed.shape

    def present(region):
        return (np.isin(cp, np.unique(region)) & valid).astype(np.int64)

    cells = []
    for i in range(grid[0]):
        for j in range(grid[1]):
            y1, y2 = int(i * h / grid[0]), int((i + 1) * h / grid[0])
            x1, x2 = int(j * w / grid[1]), int((j + 1) * w / grid[1])
            cells.append(present(packed[y1:y2, x1:x2]))
    return present(packed), np.stack(cells)


class FeatureStoreWriter:
    """Encodes frame batches with one or more FrozenEncoders and writes .npz stores.

    `last_split_s` holds the seconds of the last `write_thor_split`, split into
    "encode" (the batches' copies to the card, the encodes and the features' copies
    back), "labels" and "write"."""

    def __init__(self, encoders: Mapping[str, object], batch_size: int = 256):
        # encoders: e.g. {"imagenet": build_encoder("imagenet_rn50"),
        #                 "clip": build_encoder("clip_rn50")}
        self.encoders = dict(encoders)
        self.batch_size = batch_size
        self.last_split_s: Dict[str, float] = {}
        # Two encoders of the same family emit the same output keys
        # (clip_conv/...): silently merging them would misalign or
        # shape-mismatch far from the cause — reject up front.
        prefixes = [getattr(getattr(e, "spec", None), "family", str(i))
                    for i, e in enumerate(self.encoders.values())]
        assert len(set(prefixes)) == len(prefixes), (
            f"encoders share output key prefixes {prefixes}; "
            "one encoder per family (clip/imagenet) per writer")

    def encode_frames(self, frames_u8: np.ndarray) -> Dict[str, np.ndarray]:
        """uint8 (N,H,W,3) → every encoder's feature keys, f32 numpy arrays."""
        out: Dict[str, List[np.ndarray]] = {}
        n = len(frames_u8)
        for lo in range(0, n, self.batch_size):
            batch = torch.from_numpy(np.ascontiguousarray(frames_u8[lo: lo + self.batch_size]))
            for enc in self.encoders.values():
                for key, val in enc.encode(batch).items():
                    # cache in f32 regardless of compute dtype — the reference
                    # .float()s before caching (thor_image_features.py:111-113),
                    # and npz can't hold bfloat16
                    out.setdefault(key, []).append(val.float().cpu().numpy())
        return {k: np.concatenate(v) for k, v in out.items()}

    # ------------------------------------------------------------------ THOR probing

    def write_thor_split(
        self,
        out_dir: str,
        split: str,
        frames: np.ndarray,
        semantic_frames: Optional[np.ndarray] = None,
        object_id_to_colors: Optional[Sequence[Mapping]] = None,
        free_space: Optional[np.ndarray] = None,
        scenes: Optional[Sequence[str]] = None,
        labels: Optional[Dict[str, np.ndarray]] = None,
    ) -> str:
        """Encode `frames` and write thor_{split}.npz with features + labels.

        Labels either precomputed via `labels` (object_presence (N,52),
        object_localization (N,9,52), free_space (N,)) or derived from
        semantic_frames + object_id_to_colors + free_space.
        """
        if labels is None:
            # validate BEFORE the expensive encode
            assert (semantic_frames is not None
                    and object_id_to_colors is not None
                    and free_space is not None), (
                "deriving labels needs semantic_frames, object_id_to_colors "
                "AND free_space (or pass precomputed labels=)")
        t0 = time.perf_counter()
        store = self.encode_frames(frames)
        t1 = time.perf_counter()
        if labels is None:
            pres, grid = [], []
            for sem, colors in zip(semantic_frames, object_id_to_colors):
                p, g = frame_labels(sem, colors)
                pres.append(p)
                grid.append(g)
            labels = {
                "object_presence": np.stack(pres),
                "object_localization": np.stack(grid),
                "free_space": np.asarray(free_space, dtype=np.int64),
            }
        store.update(labels)
        if scenes is not None:
            store["scene"] = np.asarray(scenes)
        t2 = time.perf_counter()
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"thor_{split}.npz")
        np.savez_compressed(path, **store)
        self.last_split_s = {"encode": t1 - t0, "labels": t2 - t1,
                             "write": time.perf_counter() - t2}
        return path

    # ----------------------------------------------------------------- reachability

    def write_reachable_features(self, out_dir: str, images: Mapping[str, np.ndarray]) -> str:
        """{image_name: uint8 HWC} → reachable_image_features.npz (pooled keys only,
        reference reachable_image_features.py:94-98)."""
        names = sorted(images.keys())
        frames = np.stack([images[n] for n in names])
        feats = self.encode_frames(frames)
        pooled = {
            k: v for k, v in feats.items()
            if k in ("imagenet_avgpool", "clip_avgpool", "clip_attnpool", "clip_embed")
        }
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "reachable_image_features.npz")
        np.savez_compressed(path, image_names=np.asarray(names), **pooled)
        return path

    @staticmethod
    def write_reachable_split(out_dir: str, split: str, triples: Iterable) -> str:
        path = os.path.join(out_dir, f"reachable_{split}.json")
        with open(path, "w") as f:
            json.dump([[t[0], int(t[1]), bool(t[2])] for t in triples], f)
        return path
