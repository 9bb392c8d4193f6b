"""Probe datasets: cached-feature loading and batching (a numpy copy of
`embodied_clip_tpu/data/probing.py`).

Covers the reference's THOREmbeddingsDataset/DataModule semantics (data.py:9-86):
  - presence/localization/free_space read per-frame features from the thor_{split}
    cache; localization remaps *_avgpool → *_conv (data.py:16-19)
  - reachability joins reachable_image_features with per-split (image, obj_id,
    reachable) triples (data.py:30-41)
  - train shuffled / val+test sequential, batch 128 (train.py:136)

Two on-disk formats:
  - native: thor_{split}.npz (stacked arrays; conv maps NHWC) and
    reachable_image_features.npz + reachable_{split}.json, written by
    data/feature_store.py
  - reference-compat: torch thor_{split}.pt / reachable_*.pt/.pkl files produced by the
    original pipeline (CHW conv maps are transposed on load)

Features are memory-resident numpy arrays and each batch is one slice; batches go to
the card through `utils/prefetch.py`. The shuffle makes the same generator calls in the
same order as the JAX package's, so both packages see the same batches.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

__all__ = ["ProbeDataModule", "load_probe_split"]


def _maybe_chw_to_hwc(x: np.ndarray) -> np.ndarray:
    # conv maps: torch caches store (C,H,W) with C >> H=W; native stores (H,W,C).
    if x.ndim == 4 and x.shape[1] > x.shape[3]:
        return np.transpose(x, (0, 2, 3, 1))
    return x


def _load_pt_split(data_dir: str, split: str, embedding_type: str, prediction_type: str):
    import torch

    # The reference's caches hold python lists and ints beside tensors: they need
    # the full unpickler.
    data = torch.load(os.path.join(data_dir, f"thor_{split}.pt"), map_location="cpu",
                      weights_only=False)
    xs, ys = [], []
    for _scene, frames in data.items():
        for f in frames:
            xs.append(np.asarray(f[embedding_type], dtype=np.float32))
            ys.append(np.asarray(f[prediction_type]))
    x = np.stack(xs)
    if x.ndim == 4:
        x = _maybe_chw_to_hwc(x)
    return x, np.stack(ys)


def _load_npz_split(data_dir: str, split: str, embedding_type: str, prediction_type: str):
    with np.load(os.path.join(data_dir, f"thor_{split}.npz")) as z:
        x = np.asarray(z[embedding_type], dtype=np.float32)
        y = np.asarray(z[prediction_type])
    return _maybe_chw_to_hwc(x), y


def _load_reachability(data_dir: str, split: str, embedding_type: str):
    feats_npz = os.path.join(data_dir, "reachable_image_features.npz")
    if os.path.exists(feats_npz):
        with np.load(feats_npz, allow_pickle=False) as z:
            names = [str(n) for n in z["image_names"]]
            emb = np.asarray(z[embedding_type], dtype=np.float32)
        index = {n: i for i, n in enumerate(names)}
        with open(os.path.join(data_dir, f"reachable_{split}.json")) as f:
            triples = json.load(f)
    else:
        import torch

        feats = torch.load(
            os.path.join(data_dir, "reachable_image_features.pt"),
            map_location="cpu", weights_only=False,
        )
        names = list(feats.keys())
        emb = np.stack([np.asarray(feats[n][embedding_type], dtype=np.float32) for n in names])
        index = {n: i for i, n in enumerate(names)}
        with open(os.path.join(data_dir, f"reachable_{split}.pkl"), "rb") as f:
            triples = pickle.load(f)

    rows = np.array([index[t[0]] for t in triples], dtype=np.int64)
    obj_idx = np.array([t[1] for t in triples], dtype=np.int32)
    reach = np.array([1 if t[2] else 0 for t in triples], dtype=np.int32)
    return emb[rows], (obj_idx, reach)


def load_probe_split(data_dir: str, split: str, embedding_type: str, prediction_type: str):
    """Returns (X, Y); Y is (obj_idx, reachable) for reachability."""
    if prediction_type == "object_localization":
        # data.py:16-19 remap: probe the conv map matching the pooled embedding family.
        embedding_type = {"imagenet_avgpool": "imagenet_conv", "clip_avgpool": "clip_conv"}[
            embedding_type
        ]
    if prediction_type == "reachability":
        return _load_reachability(data_dir, split, embedding_type)
    if os.path.exists(os.path.join(data_dir, f"thor_{split}.npz")):
        return _load_npz_split(data_dir, split, embedding_type, prediction_type)
    return _load_pt_split(data_dir, split, embedding_type, prediction_type)


class ProbeDataModule:
    """train/val/test arrays + batch iterators (reference data.py:50-86 semantics)."""

    def __init__(self, data_dir: str, embedding_type: str, prediction_type: str,
                 batch_size: int = 128, seed: int = 1):
        from embodied_clip_tpu_torch.models.probes import validate_combo

        validate_combo(embedding_type, prediction_type)  # reference data.py:12-19 guards
        self.data_dir = data_dir
        self.embedding_type = embedding_type
        self.prediction_type = prediction_type
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)
        self.splits: Dict[str, Tuple] = {}

    def setup(self):
        for split in ("train", "val", "test"):
            self.splits[split] = load_probe_split(
                self.data_dir, split, self.embedding_type, self.prediction_type
            )
        return self

    def _n(self, split: str) -> int:
        x, _ = self.splits[split]
        return len(x)

    def batches(self, split: str, shuffle: Optional[bool] = None) -> Iterator[Tuple]:
        """Yield (x, y) numpy batches; final partial batch included (PL DataLoader
        default). Shuffle defaults to split=='train'."""
        x, y = self.splits[split]
        n = len(x)
        order = np.arange(n)
        if shuffle is None:
            shuffle = split == "train"
        if shuffle:
            self._rng.shuffle(order)
        for lo in range(0, n, self.batch_size):
            idx = order[lo : lo + self.batch_size]
            if self.prediction_type == "reachability":
                obj_idx, reach = y
                yield x[idx], (obj_idx[idx], reach[idx])
            else:
                yield x[idx], y[idx]

    def steps_per_epoch(self, split: str) -> int:
        return -(-self._n(split) // self.batch_size)
