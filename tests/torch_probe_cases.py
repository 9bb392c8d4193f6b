"""Shared cases for the probing tests (`test_torch_probing*.py`, `test_torch_cli.py`):
the synthetic feature stores of the JAX package's probing tests
(tests/test_probing_e2e.py:48-76, tests/test_registry_trains.py:48-73), the two packages'
probe trainers side by side, and a reader for TensorBoard event files."""

from __future__ import annotations

import json
import os
import struct

import numpy as np

from test_probing_e2e import D, N_EVAL, N_TRAIN, W_REACH, _split_arrays

__all__ = ["D", "write_store", "write_registry_store", "read_events", "one_thread",
           "jax_and_port_trainers", "port_params_np"]


def _write_reach(d, rng, m, n_triples):
    feats = rng.randn(m, D).astype(np.float32)
    names = [f"img{i:04d}" for i in range(m)]
    np.savez(os.path.join(d, "reachable_image_features.npz"),
             image_names=np.asarray(names),
             clip_avgpool=feats, clip_attnpool=feats, imagenet_avgpool=feats)
    reach = feats @ W_REACH > 0
    for split in ("train", "val", "test"):
        # Concentrate on 8 object classes so each per-class binary classifier sees
        # enough samples to be learnable in a quick test.
        idx = rng.randint(0, m, n_triples)
        objs = rng.randint(0, 8, n_triples)
        triples = [[names[i], int(o), bool(reach[i, o])] for i, o in zip(idx, objs)]
        with open(os.path.join(d, f"reachable_{split}.json"), "w") as f:
            json.dump(triples, f)


def write_store(d) -> str:
    """tests/test_probing_e2e.py's `data_dir` store in `d`: 512/128/128 frames of D=48
    pooled features, 7×7×16 conv maps, and a 256-image reachability store."""
    rng = np.random.RandomState(0)
    for split, n in [("train", N_TRAIN), ("val", N_EVAL), ("test", N_EVAL)]:
        np.savez(os.path.join(d, f"thor_{split}.npz"), **_split_arrays(rng, n))
    _write_reach(d, rng, 256, 1000)
    return str(d)


def write_registry_store(d) -> str:
    """tests/test_registry_trains.py's `probe_data_dir` store in `d`."""
    rng = np.random.RandomState(3)
    for split, n in [("train", N_TRAIN), ("val", N_EVAL), ("test", N_EVAL)]:
        np.savez(os.path.join(d, f"thor_{split}.npz"), **_split_arrays(rng, n))
    _write_reach(d, rng, 128, 400)
    return str(d)


def one_thread():
    """A module fixture's body: torch on one CPU thread while the module runs."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


# --------------------------------------------------------------------- the trainers

def jax_and_port_trainers(data_dir, prediction_type, embedding_type="clip_avgpool",
                          log_dirs=(None, None), **cfg):
    """(JAX trainer, its data module, port trainer, its data module) on the same store
    and config, the port's probe holding the JAX probe's initial params (carried across
    by `from_flax_probe_params`); the port on the CPU. `log_dirs`: (JAX's, the port's)."""
    import jax

    from embodied_clip_tpu.data.probing import ProbeDataModule as JDM
    from embodied_clip_tpu.training.supervised import ProbeTrainConfig as JCfg
    from embodied_clip_tpu.training.supervised import ProbeTrainer as JTrainer

    from embodied_clip_tpu_torch.data.probing import ProbeDataModule
    from embodied_clip_tpu_torch.models.convert import from_flax_probe_params
    from embodied_clip_tpu_torch.training.supervised import ProbeTrainConfig, ProbeTrainer

    jdm = JDM(data_dir, embedding_type, prediction_type, batch_size=128).setup()
    pdm = ProbeDataModule(data_dir, embedding_type, prediction_type, batch_size=128).setup()
    jtr = JTrainer(JCfg(embedding_type=embedding_type, prediction_type=prediction_type,
                        log_dir=log_dirs[0], **cfg))
    ptr = ProbeTrainer(ProbeTrainConfig(embedding_type=embedding_type,
                                        prediction_type=prediction_type, device="cpu",
                                        log_dir=log_dirs[1], **cfg))
    x0, _ = next(jdm.batches("train", shuffle=False))
    jtr.init(x0)
    ptr.init(x0)
    ptr.module.load_state_dict(from_flax_probe_params(jax.tree.map(np.asarray, jtr.params)))
    return jtr, jdm, ptr, pdm


def port_params_np(params):
    """The port's probe params as the JAX tree's numpy arrays ({name: {kernel, bias}})."""
    out = {}
    for key, v in params.items():
        name, leaf = key.rsplit(".", 1)
        v = v.detach().cpu().numpy()
        out.setdefault(name, {})["kernel" if leaf == "weight" else "bias"] = \
            v.T if leaf == "weight" else v
    return out


# ---------------------------------------------------------------- tensorboard events

def _varint(buf, off):
    shift = value = 0
    while True:
        b = buf[off]
        off += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, off


def _fields(buf):
    """(field number, wire type, value) of a protobuf message's fields."""
    off = 0
    while off < len(buf):
        key, off = _varint(buf, off)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, off = _varint(buf, off)
        elif wire == 1:
            value, off = buf[off:off + 8], off + 8
        elif wire == 5:
            value, off = buf[off:off + 4], off + 4
        else:
            n, off = _varint(buf, off)
            value, off = buf[off:off + n], off + n
        yield field, wire, value


def read_events(directory):
    """[(tag, step, value)] of the scalar events in `directory`'s event files, in
    the order written."""
    out = []
    for name in sorted(os.listdir(directory)):
        if not name.startswith("events.out.tfevents"):
            continue
        data = open(os.path.join(directory, name), "rb").read()
        off = 0
        while off < len(data):
            (length,) = struct.unpack("<Q", data[off:off + 8])
            payload = data[off + 12:off + 12 + length]
            off += 16 + length
            step, summary = 0, None
            for field, _, value in _fields(payload):
                if field == 2:
                    step = value
                elif field == 5:
                    summary = value
            if summary is None:
                continue
            for field, _, value in _fields(summary):
                if field != 1:
                    continue
                tag, simple = None, None
                for f2, _, v2 in _fields(value):
                    if f2 == 1:
                        tag = v2.decode()
                    elif f2 == 2:
                        (simple,) = struct.unpack("<f", v2)
                out.append((tag, step, simple))
    return out
