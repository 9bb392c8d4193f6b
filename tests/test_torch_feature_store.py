"""The port's feature store and extraction (`embodied_clip_tpu_torch/data/feature_store.py`,
`generate_data/{extract,reachable_metadata,thor_frames}.py`) against the JAX package's,
on the CPU:
  - `class_masks`, `presence_labels` and `grid_presence_labels` bit-equal, and the
    writer's `frame_labels` equal to them;
  - `FeatureStoreWriter` over a stub encoder (the store → probe hand-off of
    tests/test_feature_pipeline.py) equal to JAX's writer;
  - `extract_thor_features` at `clip_rn_tiny` in f32, bf16 and int8 against JAX's on the
    same weights (carried across by `from_flax_variables`): the npz keys equal, the labels
    bit-equal, the features within tests/test_torch_encoder.py's limits (1e-4 cosine in
    f32, 1e-3 in bf16) and tests/test_torch_quantize.py's in int8 (1e-3);
  - the reachability metadata and the scene split rule equal to JAX's, and a reachability
    store read back by `load_probe_split`.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_clip_tpu.data import feature_store as jfs
from embodied_clip_tpu.generate_data import reachable_metadata as jrm
from embodied_clip_tpu.generate_data import thor_frames as jtf
from embodied_clip_tpu.models.encoders import build_encoder as jax_build_encoder

from embodied_clip_tpu_torch.constants import TARGET_OBJECTS
from embodied_clip_tpu_torch.data import feature_store as pfs
from embodied_clip_tpu_torch.data.probing import ProbeDataModule, load_probe_split
from embodied_clip_tpu_torch.generate_data import reachable_metadata as prm
from embodied_clip_tpu_torch.generate_data import thor_frames as ptf
from embodied_clip_tpu_torch.models.convert import from_flax_variables
from embodied_clip_tpu_torch.parity import cosine_distance, golden_frames
from torch_probe_cases import one_thread


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    yield from one_thread()


def _semantic(rng, n, h, w, colors, k=6):
    """n semantic frames with k rectangles of the colour-mapped classes each."""
    names = list(colors)
    sems = np.zeros((n, h, w, 3), np.uint8)
    for i in range(n):
        for _ in range(k):
            y0, x0 = rng.randint(0, h - 4), rng.randint(0, w - 4)
            sems[i, y0:y0 + rng.randint(1, h // 2), x0:x0 + rng.randint(1, w // 2)] = \
                colors[names[rng.randint(len(names))]]
    return sems


def test_labels_bit_equal_to_jax():
    rng = np.random.RandomState(0)
    colors = {o: tuple(int(c) for c in rng.randint(1, 256, 3)) for o in TARGET_OBJECTS[::3]}
    colors["NotATarget"] = (1, 2, 3)
    for h, w in ((30, 30), (31, 47), (300, 300)):
        for sem in _semantic(rng, 3, h, w, colors):
            m, jm = pfs.class_masks(sem, colors), jfs.class_masks(sem, colors)
            assert m.dtype == jm.dtype and np.array_equal(m, jm)
            for fn, jfn in ((pfs.presence_labels, jfs.presence_labels),
                            (pfs.grid_presence_labels, jfs.grid_presence_labels)):
                got, want = fn(m), jfn(jm)
                assert got.dtype == want.dtype and np.array_equal(got, want)
            assert pfs.grid_presence_labels(m).shape == (9, 52)
            # the writer's route: the colours present per cell, no masks
            for got, want in zip(pfs.frame_labels(sem, colors),
                                 (jfs.presence_labels(jm), jfs.grid_presence_labels(jm))):
                assert got.dtype == want.dtype and np.array_equal(got, want)
    # a frame that is not uint8 takes the masks
    sem = _semantic(rng, 1, 20, 20, colors)[0].astype(np.int32)
    sem[0, 0] = (300, 2, 1)
    jm = jfs.class_masks(sem, colors)
    for got, want in zip(pfs.frame_labels(sem, colors),
                         (jfs.presence_labels(jm), jfs.grid_presence_labels(jm))):
        assert np.array_equal(got, want)


class _TorchStub:
    """Deterministic frames → features map with the reference key schema."""

    def encode(self, frames):
        f = torch.as_tensor(np.asarray(frames)).float() / 255.0
        pooled = f.mean(dim=(1, 2))
        emb = torch.cat([pooled, pooled ** 2, -pooled, pooled * 3], -1)
        conv = torch.stack([f[:, ::4, ::4, :]] * 2, -1).reshape(
            f.shape[0], f.shape[1] // 4, f.shape[2] // 4, 6)
        return {"clip_conv": conv, "clip_avgpool": emb, "clip_attnpool": emb}


class _JaxStub:
    def encode(self, frames):
        f = frames.astype(jnp.float32) / 255.0
        pooled = f.mean(axis=(1, 2))
        emb = jnp.concatenate([pooled, pooled ** 2, -pooled, pooled * 3], -1)
        conv = jnp.stack([f[:, ::4, ::4, :]] * 2, -1).reshape(
            f.shape[0], f.shape[1] // 4, f.shape[2] // 4, 6)
        return {"clip_conv": conv, "clip_avgpool": emb, "clip_attnpool": emb}


def test_feature_store_to_probe_training(tmp_path):
    """tests/test_feature_pipeline.py's hand-off on the port: frames + semantic masks in,
    thor_{split}.npz out (equal to JAX's writer's), read by ProbeDataModule, a probe
    trains."""
    rng = np.random.RandomState(0)
    writer = pfs.FeatureStoreWriter({"stub": _TorchStub()}, batch_size=16)
    jwriter = jfs.FeatureStoreWriter({"stub": _JaxStub()}, batch_size=16)
    color_map = {o: (i + 1, 2 * i + 1, 3 * i + 1) for i, o in enumerate(TARGET_OBJECTS[:5])}
    for split, count in {"train": 48, "val": 16, "test": 16}.items():
        frames = rng.randint(0, 256, (count, 24, 24, 3), np.uint8)
        sems = np.zeros((count, 24, 24, 3), np.uint8)
        for i in range(count):
            sems[i, :8, :8] = color_map[TARGET_OBJECTS[i % 5]]  # the top-left grid cell
        free = rng.randint(0, 14, count)
        kw = dict(frames=frames, semantic_frames=sems, object_id_to_colors=[color_map] * count,
                  free_space=free, scenes=[f"FloorPlan{i % 4}" for i in range(count)])
        path = writer.write_thor_split(str(tmp_path), split, **kw)
        jpath = jwriter.write_thor_split(str(tmp_path / "jax"), split, **kw)
        assert set(writer.last_split_s) == {"encode", "labels", "write"}
        with np.load(path) as z, np.load(jpath) as jz:
            assert set(z.files) == set(jz.files)
            for k in ("object_presence", "object_localization", "free_space", "scene"):
                assert z[k].dtype == jz[k].dtype and np.array_equal(z[k], jz[k]), k
            for k in ("clip_conv", "clip_avgpool", "clip_attnpool"):
                assert z[k].dtype == np.float32
                np.testing.assert_allclose(z[k], jz[k], rtol=0, atol=1e-5)  # f32 sum order
            assert z["object_presence"].shape == (count, 52)
            assert z["object_localization"].shape == (count, 9, 52)
            planted = [TARGET_OBJECTS.index(TARGET_OBJECTS[i % 5]) for i in range(count)]
            assert all(z["object_presence"][i, planted[i]] == 1 for i in range(count))
            assert all(z["object_localization"][i, 0, planted[i]] == 1 for i in range(count))
            assert z["object_localization"][:, 1:, :].sum() == 0

    from embodied_clip_tpu_torch.training.supervised import ProbeTrainConfig, ProbeTrainer

    dm = ProbeDataModule(str(tmp_path), "clip_avgpool", "object_presence",
                         batch_size=16).setup()
    tr = ProbeTrainer(ProbeTrainConfig(embedding_type="clip_avgpool",
                                       prediction_type="object_presence", max_epochs=2,
                                       device="cpu"))
    tr.fit(dm)
    assert np.isfinite(tr.test(dm)["loss"])


def test_writer_rejects_two_encoders_of_one_family():
    from embodied_clip_tpu_torch.models.encoders import build_encoder

    a = build_encoder("clip_rn_tiny", device="cpu")
    with pytest.raises(AssertionError, match="prefixes"):
        pfs.FeatureStoreWriter({"a": a, "b": a})


def _write_scenes(root):
    """Reference-format scene files (thor_frames.py's schema): 2 train scenes of 3 frames
    and 1 val scene of 2, 64×64 golden-frame textures, a planted Apple (top-left cell)."""
    color_map = {TARGET_OBJECTS[1]: (10, 20, 30), TARGET_OBJECTS[7]: (200, 1, 5)}
    frames = golden_frames(8, size=64)
    rng = np.random.RandomState(0)
    k = 0
    for split, scenes, n in (("train", ["FloorPlan1", "FloorPlan2"], 3),
                             ("val", ["FloorPlan21"], 2)):
        d = os.path.join(root, split)
        os.makedirs(d)
        for scene in scenes:
            records = []
            for _ in range(n):
                sem = np.zeros((64, 64, 3), np.uint8)
                sem[:16, :16] = color_map[TARGET_OBJECTS[1]]
                sem[50:, 30:40] = color_map[TARGET_OBJECTS[7]]
                records.append({"frame": frames[k], "semantic_frame": sem,
                                "object_id_to_color": color_map,
                                "valid_moves_forward": int(rng.randint(0, 14))})
                k += 1
            np.save(os.path.join(d, f"{scene}.npy"), records)


@pytest.fixture(scope="module")
def tiny_sd():
    jenc = jax_build_encoder("clip_rn_tiny", dtype=jnp.float32)
    return from_flax_variables(jax.tree.map(np.asarray, jenc.variables))


@pytest.mark.parametrize("dtype,limit", [("float32", 1e-4), ("bfloat16", 1e-3),
                                         ("int8", 1e-3)])
def test_extract_thor_features_matches_jax(tmp_path, monkeypatch, tiny_sd, dtype, limit):
    from embodied_clip_tpu.generate_data.extract import extract_thor_features as jax_extract

    from embodied_clip_tpu_torch.generate_data import extract
    from embodied_clip_tpu_torch.models import encoders

    build = encoders.build_encoder

    def with_jax_weights(name, dtype=torch.float32, device="cuda", **kw):
        enc = build(name, dtype=dtype, device=device, **kw)
        assert not enc.module.folded  # extraction builds unfolded encoders, as JAX's
        return enc.load_torch_state_dict(tiny_sd)

    monkeypatch.setattr(encoders, "build_encoder", with_jax_weights)
    _write_scenes(str(tmp_path / "scenes"))
    jax_extract(str(tmp_path / "scenes"), str(tmp_path / "jax"), encoder_names=["clip_rn_tiny"],
                batch_size=4, dtype=dtype)
    writer = extract.extract_thor_features(
        str(tmp_path / "scenes"), str(tmp_path / "port"), encoder_names=["clip_rn_tiny"],
        batch_size=4, dtype=dtype, device="cpu")
    enc = writer.encoders["clip_rn_tiny"]
    assert enc.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    assert hasattr(enc, "qtrunk") == (dtype == "int8")
    for split, n in (("train", 6), ("val", 2)):
        with np.load(str(tmp_path / "port" / f"thor_{split}.npz")) as z, \
                np.load(str(tmp_path / "jax" / f"thor_{split}.npz")) as jz:
            assert set(z.files) == set(jz.files) == {
                "clip_conv", "clip_avgpool", "clip_attnpool", "object_presence",
                "object_localization", "free_space", "scene"}
            for k in ("object_presence", "object_localization", "free_space", "scene"):
                assert z[k].dtype == jz[k].dtype and np.array_equal(z[k], jz[k]), k
            assert z["object_presence"][:, [1, 7]].all() and z["object_presence"].sum() == 2 * n
            assert z["object_localization"][:, 0, 1].all()
            for k in ("clip_conv", "clip_avgpool", "clip_attnpool"):
                assert z[k].dtype == np.float32 and z[k].shape == jz[k].shape
                assert z[k].shape[0] == n and np.isfinite(z[k]).all()
                d = cosine_distance(z[k], jz[k])
                assert d <= limit, (dtype, split, k, d)


def test_reachable_metadata_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    all_classes = ["Apple", "Bed", "Cup", "Mug", "Coffee_Machine"]
    for si, split in enumerate(("train", "val", "test")):
        boxes, pickable = {}, {}
        for i in range(12):
            objs = [f"{all_classes[(i + j + si) % 5]}_{j}" for j in range(3)]
            boxes[f"{split}_img{i}"] = {o: [0, 0, 1, 1] for o in objs}
            pickable[f"{split}_img{i}"] = [o for o in objs if rng.rand() < 0.5]
        with open(os.path.join(tmp_path, f"{split}_boxes.json"), "w") as f:
            json.dump(boxes, f)
        with open(os.path.join(tmp_path, f"{split}_boxes_pickupable.json"), "w") as f:
            json.dump(pickable, f)
    assert prm.build_object_superset(str(tmp_path)) == jrm.build_object_superset(str(tmp_path))
    superset = prm.build_object_superset(str(tmp_path))
    boxes, pick = prm._load_boxes(str(tmp_path), "train")
    assert (prm.build_split_triples(boxes, pick, superset, random.Random(5))
            == jrm.build_split_triples(boxes, pick, superset, random.Random(5)))
    prm.main(str(tmp_path), str(tmp_path / "port"), seed=1, write_pickle=True)
    jrm.main(str(tmp_path), str(tmp_path / "jax"), seed=1, write_pickle=True)
    for name in sorted(os.listdir(tmp_path / "jax")):
        assert (open(tmp_path / "port" / name, "rb").read()
                == open(tmp_path / "jax" / name, "rb").read()), name
    for s in ("FloorPlan1_physics", "FloorPlan20", "FloorPlan21", "FloorPlan26",
              "FloorPlan425", "FloorPlan430"):
        assert ptf.split_of_scene(s) == jtf.split_of_scene(s)
    assert ptf.CAMERA == jtf.CAMERA and ptf.FRAMES_PER_SCENE == jtf.FRAMES_PER_SCENE


def test_reachability_store_reads_back(tmp_path):
    """write_reachable_features on arrays (no PIL) + the triples of
    `build_split_triples` → `load_probe_split(..., "reachability")`."""
    from embodied_clip_tpu_torch.models.encoders import build_encoder

    frames = golden_frames(6, size=64)
    names = [f"edge_{i}" for i in range(6)]
    writer = pfs.FeatureStoreWriter({"clip": build_encoder("clip_rn_tiny", device="cpu")},
                                    batch_size=4)
    path = writer.write_reachable_features(str(tmp_path), dict(zip(names, frames)))
    boxes = {n: {f"{c}_0": [0, 0, 1, 1] for c in ("Mug", "Apple")[: 1 + i % 2]}
             for i, n in enumerate(names)}
    pick = {n: ["Mug_0"] if i % 3 else [] for i, n in enumerate(names)}
    superset = ["Apple", "Mug"]
    for split in ("train", "val", "test"):
        triples = prm.build_split_triples(boxes, pick, superset, random.Random(0))
        pfs.FeatureStoreWriter.write_reachable_split(str(tmp_path), split, triples)
    x, (obj, reach) = load_probe_split(str(tmp_path), "train", "clip_avgpool", "reachability")
    with np.load(path) as z:
        assert list(z["image_names"]) == sorted(names)
        assert set(z.files) == {"image_names", "clip_avgpool", "clip_attnpool"}
        feats = dict(zip(z["image_names"], z["clip_avgpool"]))
    assert len(x) == len(triples) and x.shape[1] == 256 and obj.dtype == np.int32
    for row, t in zip(x, triples):
        np.testing.assert_array_equal(row, feats[t[0]])
    assert list(reach) == [int(t[2]) for t in triples]
