"""Reachability-probe metadata (a copy of
`embodied_clip_tpu/generate_data/reachable_metadata.py`; behavioral port of the
reference pipeline).

Reproduces generate_data/reachable_metadata.py's behavior: from CSR
`{split}_boxes.json` (per-image object boxes) and `{split}_boxes_pickupable.json`
(reachable object ids), build the sorted 110-class object superset over ALL splits
(reference :24-36 — the source of the reachability head's 110 dims, train.py:31),
emit per-class (image, obj_id, reachable) triples with negatives truncated to class
balance (:47-60), shuffle, and write per-split metadata consumed by
data/probing.py. Native output is JSON (reachable_{split}.json); `--pickle` also
writes the reference's reachable_{split}.pkl format.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import random
from typing import Dict, List, Sequence, Tuple

__all__ = ["strip_instance_suffix", "build_object_superset", "build_split_triples"]

SPLITS = ("train", "val", "test")


def strip_instance_suffix(thor_id: str) -> str:
    """'Mug_3f5a' → 'Mug' (reference thor_id_to_class, :18-21)."""
    return thor_id.split("_", 1)[0] if "_" in thor_id else thor_id


def _load_boxes(data_dir: str, split: str):
    with open(os.path.join(data_dir, f"{split}_boxes.json")) as f:
        boxes = json.load(f)
    with open(os.path.join(data_dir, f"{split}_boxes_pickupable.json")) as f:
        pickupable = json.load(f)
    return boxes, pickupable


def build_object_superset(data_dir: str, splits: Sequence[str] = SPLITS) -> List[str]:
    classes = set()
    for split in splits:
        boxes, _ = _load_boxes(data_dir, split)
        for image_objects in boxes.values():
            classes.update(strip_instance_suffix(o) for o in image_objects)
    return sorted(classes)


def build_split_triples(boxes: Dict, pickupable: Dict, superset: Sequence[str],
                        rng: random.Random) -> List[Tuple[str, int, bool]]:
    index = {c: i for i, c in enumerate(superset)}
    per_class: List[List[Tuple[str, int, bool]]] = [[] for _ in superset]
    for image, image_objects in boxes.items():
        present = {strip_instance_suffix(o) for o in image_objects}
        reachable = {strip_instance_suffix(o) for o in pickupable.get(image, [])}
        for cls in present:
            i = index[cls]
            per_class[i].append((image, i, cls in reachable))

    triples: List[Tuple[str, int, bool]] = []
    for samples in per_class:
        positives = [s for s in samples if s[2]]
        negatives = [s for s in samples if not s[2]][: len(positives)]
        triples.extend(negatives + positives)
    rng.shuffle(triples)
    return triples


def main(data_dir: str, output_dir: str, seed: int = 0, write_pickle: bool = False):
    rng = random.Random(seed)
    superset = build_object_superset(data_dir)
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "reachable_classes.json"), "w") as f:
        json.dump(superset, f)
    for split in SPLITS:
        boxes, pickupable = _load_boxes(data_dir, split)
        triples = build_split_triples(boxes, pickupable, superset, rng)
        with open(os.path.join(output_dir, f"reachable_{split}.json"), "w") as f:
            json.dump([[t[0], t[1], t[2]] for t in triples], f)
        if write_pickle:
            with open(os.path.join(output_dir, f"reachable_{split}.pkl"), "wb") as f:
                pickle.dump(triples, f)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--data_dir", default="data/CSR/edge_full")
    p.add_argument("--output_dir", default="data")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pickle", action="store_true", dest="write_pickle")
    args = p.parse_args()
    main(args.data_dir, args.output_dir, args.seed, args.write_pickle)
