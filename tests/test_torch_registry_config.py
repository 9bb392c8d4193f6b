"""The port's seeding, TensorBoard writer, checkpoints and experiment registry
(`embodied_clip_tpu_torch/utils/{seeding,tensorboard,checkpoint}.py`,
`config/{experiments,rl_experiments}.py`) against the JAX package's: the same seeds, the
same event bytes, JAX's checkpoint contracts and error messages, the same 18 RL names
(and the 11 probing names) with the same fields, overrides and derived settings.
"""

import dataclasses
import os
import random
import struct

import numpy as np
import pytest
import torch

from embodied_clip_tpu.config import experiments as jexp
from embodied_clip_tpu.config import rl_experiments as jrl

from embodied_clip_tpu_torch.config import experiments as pexp
from embodied_clip_tpu_torch.config import rl_experiments as prl
from embodied_clip_tpu_torch.training.optim import ClippedAdam
from embodied_clip_tpu_torch.utils import checkpoint as pck
from embodied_clip_tpu_torch.utils import tensorboard as ptb

JAX_RL_NAMES = sorted(n for n in jexp._REGISTRY if not n.startswith("probe_"))
PORT_ONLY_FIELDS = {"device"}


# ------------------------------------------------------------------------- seeding

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_seed_everything_matches_jax(seed):
    from embodied_clip_tpu.utils.seeding import seed_everything as jax_seed
    from embodied_clip_tpu_torch.utils.seeding import seed_everything

    jax_seed(seed)
    want = (random.random(), np.random.rand(4))
    gen = seed_everything(seed, device="cpu")
    got = (random.random(), np.random.rand(4))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    assert os.environ["PYTHONHASHSEED"] == str(seed)
    assert isinstance(gen, torch.Generator) and gen.device == torch.device("cpu")
    assert gen.initial_seed() == seed


# --------------------------------------------------------------------- tensorboard

def _records(data: bytes):
    off, records = 0, []
    while off < len(data):
        (length,) = struct.unpack("<Q", data[off:off + 8])
        (len_crc,) = struct.unpack("<I", data[off + 8:off + 12])
        assert len_crc == ptb._masked_crc(data[off:off + 8])
        payload = data[off + 12:off + 12 + length]
        (pay_crc,) = struct.unpack("<I", data[off + 12 + length:off + 16 + length])
        assert pay_crc == ptb._masked_crc(payload)
        records.append(payload)
        off += 16 + length
    return records


def _event_file(mod, directory, monkeypatch):
    monkeypatch.setattr(mod.time, "time", lambda: 1700000000.25)
    w = mod.SummaryWriter(str(directory))
    for tag, value, step, wall in (("loss", 0.5, 1, 10.0), ("success", 0.75, 2, 11.5),
                                   ("env_steps_per_s", 2946.25, 2048, 12.0)):
        w.add_scalar(tag, value, step, wall_time=wall)
    w.close()
    (name,) = [f for f in os.listdir(directory) if f.startswith("events.out.tfevents")]
    return open(os.path.join(directory, name), "rb").read()


def test_tensorboard_events_byte_equal_to_jax(tmp_path, monkeypatch):
    from embodied_clip_tpu.utils import tensorboard as jtb

    got = _event_file(ptb, tmp_path / "port", monkeypatch)
    want = _event_file(jtb, tmp_path / "jax", monkeypatch)
    assert got == want
    records = _records(got)  # the reader check of tests/test_generate_data.py
    assert len(records) == 4
    assert b"brain.Event:2" in records[0]
    assert b"loss" in records[1] and b"success" in records[2]


# ---------------------------------------------------------------------- checkpoints

def _state(width):
    return {"params": {"w": torch.zeros(width)},
            "opt_state": {"count": torch.zeros((), dtype=torch.int32)}}


def test_restore_latest_returns_matching_state(tmp_path):
    ck = pck.StepCheckpointer(str(tmp_path), prefix="exp")
    ck.save(128, _state(3))
    assert os.listdir(tmp_path) == ["exp__steps_000000000128.pt"]
    step, state = ck.restore_latest(_state(3))
    assert step == 128
    assert state["params"]["w"].shape == (3,)


def test_restore_latest_rejects_shape_mismatch(tmp_path):
    ck = pck.StepCheckpointer(str(tmp_path), prefix="exp")
    ck.save(128, _state(3))
    with pytest.raises(ValueError, match="different experiment config") as e:
        ck.restore_latest(_state(5))
    assert "leaf 'params/w' has shape (3,), expected (5,)" in str(e.value)


def test_restore_latest_rejects_different_tree(tmp_path):
    ck = pck.StepCheckpointer(str(tmp_path), prefix="exp")
    ck.save(64, _state(3))
    other = {"params": {"w": torch.zeros(3), "b": torch.zeros(3)},
             "opt_state": {"count": torch.zeros((), dtype=torch.int32)}}
    with pytest.raises(ValueError, match="different experiment config"):
        ck.restore_latest(other)
    swapped = {"params": {"v": torch.zeros(3)},
               "opt_state": {"count": torch.zeros((), dtype=torch.int32)}}
    with pytest.raises(ValueError, match="diverges at leaf 'params/w' "
                                         r"\(expected 'params/v'\)"):
        ck.restore_latest(swapped)


def test_latest_step_picks_the_largest_stamp(tmp_path):
    ck = pck.StepCheckpointer(str(tmp_path), prefix="exp")
    assert ck.restore_latest(_state(3)) == (None, None)
    for step in (64, 1024, 256):
        ck.save(step, _state(3))
    open(os.path.join(tmp_path, "exp__steps_000000009999.pt.tmp"), "w").close()
    open(os.path.join(tmp_path, "other__steps_000000099999.pt"), "w").close()
    assert ck.latest_step() == 1024


def test_restore_params_checks_key_paths(tmp_path):
    """The port's version of tests/test_rl_extras.py:506-529."""
    saved = {"params": {"actor": {"kernel": torch.ones(3, 2)},
                        "critic": {"kernel": torch.zeros(4)}}}
    path = str(tmp_path / "ckpt.pt")
    pck.save_pytree(path, saved)
    template = {"actor2": {"kernel": torch.zeros(3, 2)},
                "critic": {"kernel": torch.zeros(4)}}
    with pytest.raises(ValueError, match="actor"):
        pck.restore_params(path, template)
    with pytest.raises(ValueError, match=r"shape \(3, 2\) != expected \(2, 3\)"):
        pck.restore_params(path, {"actor": {"kernel": torch.zeros(2, 3)},
                                  "critic": {"kernel": torch.zeros(4)}})
    good = {"actor": {"kernel": torch.zeros(3, 2, dtype=torch.float64)},
            "critic": {"kernel": torch.zeros(4)}}
    out = pck.restore_params(path, good)
    np.testing.assert_array_equal(out["actor"]["kernel"].numpy(), np.ones((3, 2)))
    assert out["actor"]["kernel"].dtype == torch.float64
    # a bare params tree (a policy's state_dict) restores the same way
    pck.save_pytree(path, {"gru.weight": torch.ones(2)})
    assert pck.restore_params(path, {"gru.weight": torch.zeros(2)})["gru.weight"].sum() == 2


@pytest.mark.parametrize("mode", ["min", "max"])
def test_best_checkpointer_matches_jax(tmp_path, mode):
    from embodied_clip_tpu.utils.checkpoint import BestCheckpointer as JaxBest

    values = [0.9, 0.7, 0.8, 0.7, 0.2, 1.5, 1.5, -0.1]
    jb, pb = JaxBest(mode=mode), pck.BestCheckpointer(str(tmp_path), mode=mode)
    want, got = [], []
    for i, v in enumerate(values):
        want.append(jb.update(v, {"w": np.full(2, i, np.float32)}, tag=str(i)))
        got.append(pb.update(v, {"w": torch.full((2,), float(i))}, tag=str(i)))
    assert got == want
    assert pb.best_value == jb.best_value and pb.best_tag == jb.best_tag
    saved = torch.load(tmp_path / "best.pt", weights_only=True)
    assert float(saved["w"][0]) == float(pb.best_tag)


def test_checkpoint_loads_with_weights_only(tmp_path):
    pol = torch.nn.Linear(3, 2)
    tx = ClippedAdam(pol.parameters(), lr=1e-3, max_grad_norm=0.5, decay_updates=10)
    gen = torch.Generator().manual_seed(3)
    state = {"params": pol.state_dict(), "opt_state": tx.state_dict(),
             "generator": [gen.get_state()]}
    path = pck.StepCheckpointer(str(tmp_path), prefix="exp").save(7, state)
    raw = torch.load(path, weights_only=True)
    assert raw["opt_state"]["count"].dtype == torch.int64
    assert torch.equal(raw["generator"][0], gen.get_state())


def test_clipped_adam_state_round_trip():
    """A second optimizer loaded from the first's state takes the same next update."""
    torch.manual_seed(0)
    a, b = torch.nn.Linear(4, 3), torch.nn.Linear(4, 3)
    b.load_state_dict(a.state_dict())
    ta = ClippedAdam(a.parameters(), lr=1e-2, max_grad_norm=0.5, decay_updates=5)
    tb = ClippedAdam(b.parameters(), lr=1e-2, max_grad_norm=0.5, decay_updates=5)
    for _ in range(3):
        ta.step([torch.randn_like(p) for p in ta.params])
    b.load_state_dict(a.state_dict())
    tb.load_state_dict(ta.state_dict())
    assert tb.count == 3 and tb.learning_rate() == ta.learning_rate()
    g = [torch.randn_like(p) for p in ta.params]
    ta.step(g)
    tb.step([x.clone() for x in g])
    for pa, pb_ in zip(ta.params, tb.params):
        assert torch.equal(pa, pb_)
    with pytest.raises(ValueError, match="moments"):
        tb.load_state_dict({"count": torch.tensor(1), "mu": [], "nu": []})


# ------------------------------------------------------------------------- registry

def test_list_experiments_matches_jax_rl_names():
    names = pexp.list_experiments()
    assert [n for n in names if not n.startswith("probe_")] == JAX_RL_NAMES
    assert len(JAX_RL_NAMES) == 18
    assert names == jexp.list_experiments() and len(names) == 29  # with the probing grid


@pytest.mark.parametrize("name", JAX_RL_NAMES)
def test_registered_fields_match_jax(name):
    j, p = jexp.get_experiment(name), pexp.get_experiment(name)
    jf = {f.name for f in dataclasses.fields(j)}
    pf = {f.name for f in dataclasses.fields(p)}
    assert pf - jf == PORT_ONLY_FIELDS and jf <= pf
    for f in sorted(jf):
        assert getattr(p, f) == getattr(j, f), f
    assert p.device == "cuda"
    assert p._goal_spec() == j._goal_spec()
    assert p._encoder_emits_map() == j._encoder_emits_map()
    for steps, kw in ((1_000_000, {}), (4096, dict(num_minibatches=16, env_batch=8)),
                      (100, {})):
        jj = dataclasses.replace(j, total_env_steps=steps, **kw)
        pp = dataclasses.replace(p, total_env_steps=steps, **kw)
        for envs in (None, 4, 7):
            assert pp._lr_decay_updates(envs) == jj._lr_decay_updates(envs), (steps, envs)
        assert (dataclasses.replace(pp, lr_decay_updates=-1)._lr_decay_updates(3)
                == dataclasses.replace(jj, lr_decay_updates=-1)._lr_decay_updates(3))


OVERRIDES = [
    ["total_env_steps=4096", "env_batch=8"],
    ["lr=1e-4", "hidden=64", "ppo_epochs=2"],
    ["encoder=none"],
    ["encoder=null", "rgbd=true"],
    ["encoder=clip_vit_b32", "zeroshot=1", "rgbd=0"],
    ["log_dir=/tmp/logs", "max_episode_steps=25"],
    ["max_episode_steps=2.5"],
    ["controller_factory=12"],
    ["encoder_dtype=int8", "seed=7", "dagger_aggregate=0"],
    ["backend=thor", "num_workers=3", "straggler_cutoff=0.75"],
    ["zeroshot=True", "rgbd=FALSE"],
]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: " ".join(o))
def test_overrides_match_jax(overrides):
    name = "objectnav_robothor_rgb_clipresnet50gru_ddppo"
    j = jexp.get_experiment(name, overrides)
    p = pexp.get_experiment(name, overrides)
    for f in dataclasses.fields(j):
        jv, pv = getattr(j, f.name), getattr(p, f.name)
        assert pv == jv and type(pv) is type(jv), (f.name, pv, jv)


@pytest.mark.parametrize("bad,err", [(("nope", []), KeyError),
                                     (("ddppo_objectnav_rgb", ["hiden=3"]), AttributeError),
                                     (("ddppo_objectnav_rgb", ["hidden=3.5"]), ValueError)])
def test_override_errors_match_jax(bad, err):
    for get in (jexp.get_experiment, pexp.get_experiment):
        with pytest.raises(err):
            get(*bad)


def test_policy_value_errors_at_config_time():
    """The port's versions of tests/test_rl_extras.py:481-504 (and the allenact and
    unknown-arch checks of `_make_policy`)."""
    exp = dataclasses.replace(pexp.get_experiment("ddppo_objectnav_rgbd_clip"),
                              encoder="clip_vit_tiny")
    with pytest.raises(ValueError, match="flat embed"):
        exp._make_policy(6, frame_obs=True)
    exp = dataclasses.replace(
        pexp.get_experiment("objectnav_robothor_rgb_clipresnet50gru_ddppo"),
        encoder="clip_rn999")
    with pytest.raises(ValueError, match="unknown encoder"):
        exp._make_policy(6, frame_obs=True)
    exp = dataclasses.replace(pexp.get_experiment("ddppo_pointnav_rgb_clip"),
                              policy_arch="allenact")
    with pytest.raises(ValueError, match="policy_arch=allenact needs"):
        exp._make_policy(6, frame_obs=True, visual_shape=(7, 7, 2048))
    exp = dataclasses.replace(exp, policy_arch="gpt")
    with pytest.raises(ValueError, match="unknown policy_arch"):
        exp._make_policy(6, frame_obs=True, visual_shape=(7, 7, 2048))


def test_dp_in_one_process_names_the_launcher(tmp_path):
    exp = dataclasses.replace(pexp.get_experiment("ddppo_objectnav_rgb"), dp=2,
                              device="cpu")
    with pytest.raises(ValueError, match="initialize_distributed"):
        exp.train(str(tmp_path))


def test_host_env_fns_match_jax():
    """Worker seeds, scenes and horizons of the host backends, as picklable partials."""
    import pickle

    from fake_thor import FakeController

    for backend in ("hostgrid", "thor"):
        for task in ("objectnav", "rearrange", "rearrange2"):
            kw = dict(backend=backend, task=task, num_workers=3,
                      controller_factory=FakeController, max_episode_steps=None)
            j = jrl.NavRLExperiment(**kw)
            p = prl.NavRLExperiment(**kw)
            for ev in (False, True):
                jf, jshape = j._host_env_fns(eval_split=ev, seed_offset=3)
                pf, pshape = p._host_env_fns(eval_split=ev, seed_offset=3)
                assert pshape == jshape and len(pf) == len(jf) == 3
                for fn in pf:
                    pickle.dumps(fn)
                assert [f.keywords["seed"] for f in pf] == [3, 4, 5]
                assert [(f.keywords["seed"],) for f in pf] == [f.__defaults__ for f in jf]
                if backend == "thor":  # JAX's factories close over the scene list
                    import inspect

                    jscenes = inspect.getclosurevars(jf[0]).nonlocals["scenes"]
                    assert list(pf[0].args[0]) == jscenes
    horizons = {("hostgrid", "objectnav"): 48, ("thor", "objectnav"): 500,
                ("thor", "rearrange"): 250}
    for (backend, task), h in horizons.items():
        p = prl.NavRLExperiment(backend=backend, task=task, num_workers=1)
        assert prl._horizon(p._host_env_fns()[0][0]) == h
        p = dataclasses.replace(p, max_episode_steps=25)
        assert prl._horizon(p._host_env_fns()[0][0]) == 25
