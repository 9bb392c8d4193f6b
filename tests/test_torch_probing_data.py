"""The port's probe data (`embodied_clip_tpu_torch/data/probing.py`) and prefetch
(`utils/prefetch.py`) against the JAX package's, on the CPU: `ProbeDataModule` batches
bit-equal to JAX's over 2 shuffled epochs for every prediction type; the `.npz`, `.pt`
and `.pkl` loaders, the CHW → HWC transpose and the localization remap equal to JAX's.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from embodied_clip_tpu.data import probing as jdata

from embodied_clip_tpu_torch.data import probing as pdata
from embodied_clip_tpu_torch.utils.prefetch import prefetch_to_device, to_device
from test_probing_e2e import _split_arrays
from torch_probe_cases import write_store


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return write_store(tmp_path_factory.mktemp("probe_store"))


def _leaves(y):
    return list(y) if isinstance(y, tuple) else [y]


@pytest.mark.parametrize("prediction_type", ["object_presence", "object_localization",
                                             "reachability", "free_space"])
@pytest.mark.parametrize("batch_size", [128, 100])
def test_batches_bit_equal_to_jax(store, prediction_type, batch_size):
    jdm = jdata.ProbeDataModule(store, "clip_avgpool", prediction_type, batch_size).setup()
    pdm = pdata.ProbeDataModule(store, "clip_avgpool", prediction_type, batch_size).setup()
    for split in ("train", "val", "test"):
        assert pdm.steps_per_epoch(split) == jdm.steps_per_epoch(split)
    for _epoch in range(2):
        for split in ("train", "val", "test"):
            got, want = list(pdm.batches(split)), list(jdm.batches(split))
            assert len(got) == len(want) == pdm.steps_per_epoch(split)
            for (gx, gy), (wx, wy) in zip(got, want):
                assert gx.dtype == wx.dtype and np.array_equal(gx, wx)
                for a, b in zip(_leaves(gy), _leaves(wy)):
                    assert a.dtype == b.dtype and np.array_equal(a, b)
    # the last batch is the partial one (PL's drop_last=False)
    sizes = [len(x) for x, _ in pdm.batches("train")]
    assert sum(sizes) == len(pdm.splits["train"][0])


def test_npz_loader_and_localization_remap_match_jax(store):
    for emb, pred in (("clip_avgpool", "object_presence"), ("imagenet_avgpool", "free_space"),
                      ("clip_avgpool", "object_localization"),
                      ("imagenet_avgpool", "object_localization"),
                      ("clip_attnpool", "reachability")):
        got = pdata.load_probe_split(store, "val", emb, pred)
        want = jdata.load_probe_split(store, "val", emb, pred)
        for a, b in zip([got[0]] + _leaves(got[1]), [want[0]] + _leaves(want[1])):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        if pred == "object_localization":
            assert got[0].shape[1:] == (7, 7, 16)  # the conv map, NHWC


def test_pt_and_pkl_loaders_match_jax(tmp_path):
    """Reference-format thor_{split}.pt (conv maps CHW) and reachable_*.pt / .pkl files
    load as JAX loads them: CHW → HWC, the same arrays."""
    d = str(tmp_path)
    arrays = _split_arrays(np.random.RandomState(3), 8)
    data = {"FloorPlan1": [], "FloorPlan2": []}
    for i in range(8):
        data[f"FloorPlan{1 + i % 2}"].append({
            "clip_avgpool": torch.tensor(arrays["clip_avgpool"][i]),
            "clip_conv": torch.tensor(arrays["clip_conv"][i]).permute(2, 0, 1),
            "object_presence": torch.tensor(arrays["object_presence"][i]),
            "object_localization": torch.tensor(arrays["object_localization"][i]),
            "free_space": int(arrays["free_space"][i]),
        })
    for split in ("train", "val", "test"):
        torch.save(data, os.path.join(d, f"thor_{split}.pt"))
    feats = {f"img{i}": {"clip_avgpool": torch.tensor(arrays["clip_avgpool"][i])}
             for i in range(8)}
    torch.save(feats, os.path.join(d, "reachable_image_features.pt"))
    triples = [(f"img{i % 8}", i % 5, bool(i % 3)) for i in range(12)]
    with open(os.path.join(d, "reachable_train.pkl"), "wb") as f:
        pickle.dump(triples, f)

    for emb, pred in (("clip_avgpool", "object_presence"), ("clip_avgpool", "free_space"),
                      ("clip_avgpool", "object_localization"),
                      ("clip_avgpool", "reachability")):
        got = pdata.load_probe_split(d, "train", emb, pred)
        want = jdata.load_probe_split(d, "train", emb, pred)
        for a, b in zip([got[0]] + _leaves(got[1]), [want[0]] + _leaves(want[1])):
            assert a.dtype == b.dtype and np.array_equal(a, b), (emb, pred)
    xc, _ = pdata.load_probe_split(d, "train", "clip_avgpool", "object_localization")
    by_scene = np.concatenate([arrays["clip_conv"][0::2], arrays["clip_conv"][1::2]])
    np.testing.assert_array_equal(xc, by_scene)  # CHW → HWC, scene by scene


def test_chw_heuristic_matches_jax():
    for shape in ((2, 2048, 7, 7), (2, 7, 7, 2048), (2, 3, 3, 3), (2, 48)):
        x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
        got, want = pdata._maybe_chw_to_hwc(x), jdata._maybe_chw_to_hwc(x)
        assert got.shape == want.shape and np.array_equal(got, want)


def test_prefetch_on_the_cpu_copies_in_order():
    items = [(np.full((2, 3), i, np.float32), (np.arange(2) + i, np.ones(2, np.int32)))
             for i in range(5)]
    seen = []

    def gen():
        for i, item in enumerate(items):
            seen.append(i)
            yield item

    out = prefetch_to_device(gen(), size=2, device="cpu")
    first = next(out)
    assert seen == [0, 1, 2]  # two more in flight behind the one yielded
    rest = [first] + list(out)
    for i, (x, (a, b)) in enumerate(rest):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        assert float(x[0, 0]) == i and a.tolist() == [i, i + 1] and b.dtype == torch.int32
    src = np.zeros(3, np.float32)
    t = to_device(src, "cpu")
    t += 1
    assert src.sum() == 0  # a copy, not a view of the batch
