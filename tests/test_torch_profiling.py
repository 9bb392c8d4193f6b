"""The port's tracing (`utils/profiling.py`) on the CPU: spans and counters live only
while a `torch.profiler` session records, on the profiler's own clock and outside its
event list; a new session clears the store; the caps count what they drop; the stride
shortcut's near-tie count masks the tail tiles; the encoders, the rollout and the PPO
update open their spans. Imports no JAX."""

import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from embodied_clip_tpu_torch.ops.kernels import bottleneck_kernel as BK
from embodied_clip_tpu_torch.utils import profiling
from embodied_clip_tpu_torch.utils.profiling import StageTimer, count, hold, recorded, span, trace

import torch_int8_cases as C


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _end_session():
    """A span call with the profiler off, as a traced program makes between sessions."""
    with span("between"):
        pass


def _by_name(rec):
    out = {}
    for s in rec.spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_is_one_shared_noop(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("a program span reached record_function")

    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", forbidden)
    with _session():
        with span("seen"):
            count("seen.count", 2)
    before = recorded()
    assert span("a") is span("b")
    with span("a"):
        with span("b"):
            count("c", 5)
    assert not hold("h", lambda t: 1 / 0, torch.zeros(4))
    after = recorded()
    assert [s.name for s in after.spans] == [s.name for s in before.spans] == ["seen"]
    assert after.counters == before.counters == {"seen.count": 2}


def test_parent_root_and_self_time():
    _end_session()
    with _session():
        with span("outer"):
            time.sleep(0.01)
            with span("inner"):
                time.sleep(0.02)
                with span("innermost"):
                    time.sleep(0.005)
            with span("inner"):
                pass
        with span("second"):
            pass
    rec = recorded()
    spans = _by_name(rec)
    outer, (inner, inner2), innermost = spans["outer"][0], spans["inner"], spans["innermost"][0]
    second = spans["second"][0]
    assert outer.parent is None and outer.root == outer.id
    assert inner.parent == inner2.parent == outer.id and inner.root == outer.id
    assert innermost.parent == inner.id and innermost.root == outer.id
    assert second.parent is None and second.root == second.id != outer.id
    assert len({s.id for s in rec.spans}) == len(rec.spans) == 5
    assert len({s.thread for s in rec.spans}) == 1
    stats = rec.by_name()
    assert stats["inner"].calls == 2 and stats["outer"].calls == 1
    want = outer.host_s - inner.host_s - inner2.host_s
    assert stats["outer"].self_s == pytest.approx(want, abs=1e-9)
    assert stats["inner"].self_s == pytest.approx(
        inner.host_s + inner2.host_s - innermost.host_s, abs=1e-9)
    assert stats["outer"].host_s >= 0.035 and stats["outer"].self_s >= 0.01
    assert stats["outer"].stream_s is None   # no CUDA here


def test_spans_share_the_profilers_clock_and_stay_out_of_its_events():
    _end_session()
    with _session() as prof:
        with record_function("test/around"):
            time.sleep(0.002)
            with span("program.span"):
                time.sleep(0.002)
                with record_function("test/inside"):
                    time.sleep(0.002)
                time.sleep(0.002)
            time.sleep(0.002)
    events = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()}
    assert not any(name.startswith("program.") for name in events)
    s = _by_name(recorded())["program.span"][0]
    around, inside = events["test/around"], events["test/inside"]
    assert around[0] < s.start_ns < inside[0] < inside[1] < s.end_ns < around[1]


def test_new_session_clears_and_caps_count_drops(monkeypatch):
    _end_session()
    with _session():
        with span("first"):
            count("n", 1)
    assert [s.name for s in recorded().spans] == ["first"]
    _end_session()
    with _session():
        with span("second"):
            count("m", 3)
    rec = recorded()
    assert [s.name for s in rec.spans] == ["second"] and rec.counters == {"m": 3}

    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    monkeypatch.setattr(profiling, "MAX_HELD_BYTES", 64)
    _end_session()
    with _session():
        for i in range(5):
            with span(f"s{i}"):
                pass
        held = [hold("h", lambda t: int(t.sum()), torch.ones(8, dtype=torch.int32))
                for _ in range(3)]
    rec = recorded()
    assert [s.name for s in rec.spans] == ["s0", "s1", "s2"]
    assert held == [True, True, False]
    assert rec.dropped == {"spans": 2, "held:h": 1} and rec.counters == {"h": 16}


def test_buffer_is_the_arenas_while_on(monkeypatch):
    assert profiling.buffer(10, torch.int64, "cpu") is None
    monkeypatch.setattr(profiling, "ARENA_CHUNK_BYTES", 1024)
    monkeypatch.setattr(profiling, "MAX_HELD_BYTES", 4096)
    _end_session()
    with _session():
        a = profiling.buffer(10, torch.int64, "cpu")
        b = profiling.buffer(100, torch.int32, "cpu")
        c = profiling.buffer(200, torch.int64, "cpu")   # past a chunk: a chunk of its own
        over = profiling.buffer(400, torch.int64, "cpu")
        a.fill_(1), b.fill_(2), c.fill_(3)
        assert hold("a", lambda t: int(t.sum()), a) and hold("c", lambda t: int(t.sum()), c)
    assert over is None and a.dtype == torch.int64 and b.shape == (100,)
    assert a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
    assert c.untyped_storage().data_ptr() != a.untyped_storage().data_ptr()
    assert int(a.sum()) == 10 and int(b.sum()) == 200   # no overlap
    assert recorded().counters == {"a": 10, "c": 600}
    assert profiling._RECORDER.arena == []   # released once read


def test_stage_timer_is_a_span_and_trace_writes_the_spans(tmp_path):
    timer = StageTimer()
    _end_session()
    with trace(str(tmp_path)):
        with timer.stage("act"):
            torch.ones(8) + 1
        count("k", 4)
    assert timer.summary()["act_calls"] == 1.0
    files = [f for f in os.listdir(tmp_path) if f.endswith(".spans.json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        out = json.load(f)
    assert out["clock"] == "unix_ns" and out["counters"] == {"k": 4}
    (s,) = out["spans"]
    assert s["name"] == "stage.act" and s["end_ns"] > s["start_ns"] > 1.6e18
    assert out["by_name"]["stage.act"]["calls"] == 1


@pytest.mark.parametrize("m,n", [(256, 256), (200, 144), (77, 512), (128, 16)])
def test_near_tie_count_masks_the_tail(m, n):
    """Random flag words over whole tiles: the count is the set bits on elements inside
    (m, n), decoded bit by bit; the word map covers each tile's 128×128 once."""
    row_tiles, col_tiles = -(-m // 128), -(-n // 128)
    words = torch.from_numpy(np.random.RandomState(m + n).randint(
        -2 ** 63, 2 ** 63 - 1, row_tiles * col_tiles * 256, dtype=np.int64))
    rows, cols = C.shortcut_tie_elements(256, 128)
    assert len(set(zip(rows.ravel().tolist(), cols.ravel().tolist()))) == 128 * 128
    assert rows.max() == cols.max() == 127
    want = C.plain_near_ties(words, m, n)
    inside = (m * n) / (row_tiles * col_tiles * 128 * 128)
    assert want == pytest.approx(0.5 * inside * words.numel() * 64, rel=0.1)
    assert BK.shortcut_near_ties(words, m, n) == want


def _int8_tiny():
    from embodied_clip_tpu_torch.models.encoders import build_encoder
    from embodied_clip_tpu_torch.parity import golden_frames

    enc = build_encoder("clip_rn_tiny", torch.bfloat16, device="cpu").fold_bn()
    frames = golden_frames(4, 60, 60)
    return enc.quantize(frames), frames


def test_encoder_spans():
    from embodied_clip_tpu_torch.models.encoders import build_encoder

    qenc, frames = _int8_tiny()
    fenc = build_encoder("imagenet_rn18", torch.float32, device="cpu").fold_bn()
    for enc, trunk in ((qenc, {"int8.stem", "int8.block", "int8.stride_block"}),
                       (fenc, {"bf16.stem"})):
        _end_session()
        with _session():
            enc.encode(frames[:2])
        spans = _by_name(recorded())
        (root,) = spans["encode"]
        assert root.parent is None
        parts = {s.name: s for s in recorded().spans if s.parent == root.id}
        assert set(parts) == {"encode.to_device", "encode.preprocess", "encode.trunk",
                              "encode.heads"}
        inner = {s.name for s in recorded().spans if s.parent == parts["encode.trunk"].id}
        assert inner == trunk and all(s.root == root.id for s in recorded().spans)
    # the int8 trunk's three stride blocks (stages 2-4 of the tiny trunk)
    _end_session()
    with _session():
        qenc.encode(frames[:2])
    assert recorded().by_name()["int8.stride_block"].calls == 3


def test_rollout_and_update_spans():
    from embodied_clip_tpu_torch.envs.gridworld import GridNavEnv
    from embodied_clip_tpu_torch.models.policy import ActorCritic
    from embodied_clip_tpu_torch.training.ddppo import DDPPOConfig, DDPPOLearner
    from embodied_clip_tpu_torch.training.ppo import PPOConfig

    env = GridNavEnv(size=5, max_steps=16)
    obs_shape = env.reset(torch.Generator().manual_seed(0), 1)[1]["visual"].shape[1:]
    policy = ActorCritic(env.num_actions, tuple(obs_shape), goal_kind="object_embed",
                         num_goal_classes=env.num_classes, hidden=16)
    t_len = 4
    learner = DDPPOLearner(env, policy, DDPPOConfig(
        rollout_len=t_len, env_batch=4, num_minibatches=2, ppo=PPOConfig(epochs=2)),
        device="cpu")
    gen = torch.Generator().manual_seed(1)
    act = learner.init(gen)
    _end_session()
    with _session():
        learner.train_iteration(act, gen)
    rec = recorded()
    stats = rec.by_name()
    roots = [s for s in rec.spans if s.parent is None]
    assert [s.name for s in roots] == ["rollout", "update"]
    calls = {k: v.calls for k, v in stats.items()}
    assert calls == {"rollout": 1, "rollout.encode": t_len + 1, "rollout.store": 2 * t_len,
                     "rollout.policy": t_len + 1, "rollout.env": t_len, "update": 1,
                     "update.gae": 1, "update.loss": 4, "update.backward": 4,
                     "update.allreduce": 4, "update.optimizer": 4}
    for s in rec.spans:
        assert s.root == (roots[0].id if s.name.startswith("rollout") else roots[1].id)
        assert s.parent in (None, s.root)


@pytest.mark.parametrize("world", [1, 2])
def test_allreduce_bytes_counts_each_gradient_all_reduce(world, monkeypatch):
    """`allreduce.bytes` is counted only across processes: the bytes of every gradient,
    once for each minibatch's all-reduce (the collective itself stubbed out here)."""
    from embodied_clip_tpu_torch.envs.gridworld import GridNavEnv
    from embodied_clip_tpu_torch.models.policy import ActorCritic
    from embodied_clip_tpu_torch.parallel import mesh
    from embodied_clip_tpu_torch.training.ddppo import DDPPOConfig, DDPPOLearner
    from embodied_clip_tpu_torch.training.ppo import PPOConfig

    summed = []
    monkeypatch.setattr(mesh, "world_size", lambda: world)
    monkeypatch.setattr(mesh, "all_sum_", lambda ts: summed.append(list(ts)))
    env = GridNavEnv(size=5, max_steps=16)
    obs_shape = env.reset(torch.Generator().manual_seed(0), 1)[1]["visual"].shape[1:]
    policy = ActorCritic(env.num_actions, tuple(obs_shape), goal_kind="object_embed",
                         num_goal_classes=env.num_classes, hidden=16)
    learner = DDPPOLearner(env, policy, DDPPOConfig(
        rollout_len=4, env_batch=4, num_minibatches=2, ppo=PPOConfig(epochs=2)),
        device="cpu")
    gen = torch.Generator().manual_seed(1)
    act = learner.init(gen)
    _end_session()
    with _session():
        learner.train_iteration(act, gen)
    counters = recorded().counters
    per_call = sum(p.numel() * p.element_size() for p in policy.parameters())
    assert len(summed) == 4 and all(sum(g.numel() * g.element_size() for g in gs) == per_call
                                    for gs in summed)
    if world == 1:
        assert "allreduce.bytes" not in counters
    else:
        assert counters["allreduce.bytes"] == 4 * per_call
