"""The port's host rollout, host PPO and evaluation (`embodied_clip_tpu_torch/training/
host_rollout.py`, `host_ppo.py`, `evaluate.py`) against the JAX package's, on the CPU.

- `keyed_sample`: an env's action depends on (seed, t, global env id) and its logits
  only, whatever batch the env sits in; its frequencies follow the softmax;
- `HostRolloutCollector.collect` (a pool of 3 `HostGridNav` workers, the frozen
  `clip_rn_tiny` f32 encoder from one torch checkpoint, the conv-map policy) against
  JAX's collector over JAX's pool, replaying JAX's actions: frames, starts, actions,
  rewards, dones, valid flags and episode metrics equal; the stored features within
  1e-4 cosine (the f32 limit of `tests/test_torch_encoder.py`); log-probs, values and
  the bootstrap value within 1e-5;
- two pipelined groups give the rollout of one pool of the same envs;
- `HostPPOLearner.update` against JAX's `_update_impl` on the same rollout with a
  `valid` mask and an uneven B = 5 (m = 1 and m = 3): every weight within 1e-6; two
  gloo processes, each with its own pool size and `env_id_offset`, equal one process;
- `HostPPOLearner.train_iteration` publishes the stage split and env-steps/s;
- `evaluate_policy` (on-device GridNav, JAX's draws injected) and `evaluate_policy_host`
  (deterministic, pools of `HostGridNav`) deliver JAX's episodes; `write_metrics_json`
  and `compute_scores` read them as JAX's do.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_clip_tpu.envs.gridworld import GridNavEnv as JaxGridNav
from embodied_clip_tpu.envs.host_gridworld import HostGridNav as JaxHostGridNav
from embodied_clip_tpu.envs.vector import VectorEnv as JaxVectorEnv
from embodied_clip_tpu.models.encoders import build_encoder as jax_build_encoder
from embodied_clip_tpu.models.policy import ActorCritic as JaxActorCritic
from embodied_clip_tpu.training import evaluate as jax_evaluate
from embodied_clip_tpu.training.ddppo import DDPPOConfig as JaxConfig
from embodied_clip_tpu.training.host_ppo import HostPPOLearner as JaxHostPPO
from embodied_clip_tpu.training.host_rollout import HostRolloutCollector as JaxCollector
from embodied_clip_tpu.training.ppo import PPOConfig as JaxPPOConfig

from embodied_clip_tpu_torch.envs.gridworld import GridNavEnv
from embodied_clip_tpu_torch.envs.vector import VectorEnv
from embodied_clip_tpu_torch.models.convert import from_flax_policy_params, from_flax_variables
from embodied_clip_tpu_torch.models.policy import ActorCritic
from embodied_clip_tpu_torch.parallel import dryrun
from embodied_clip_tpu_torch.parity import cosine_distance
from embodied_clip_tpu_torch.training import evaluate
from embodied_clip_tpu_torch.training.ddppo import DDPPOConfig
from embodied_clip_tpu_torch.training.frames import frozen_encode_fn
from embodied_clip_tpu_torch.training.host_ppo import HostPPOLearner
from embodied_clip_tpu_torch.training.host_rollout import (
    HostRolloutCollector,
    keyed_sample,
    keyed_uniform,
)
from embodied_clip_tpu_torch.training.ppo import PPOConfig

import torch_host_cases as H
import torch_rl_cases as C


def _jax_pool(seeds, **kw):
    return JaxVectorEnv([functools.partial(JaxHostGridNav, size=5, seed=s, **kw)
                         for s in seeds], frame_shape=H.FRAME)


def _recording(collector):
    """Wrap a JAX collector's act step to record the actions it samples."""
    recorded, act_step = [], collector._act_step

    def record(*args):
        out = act_step(*args)
        recorded.append(np.asarray(out[0]))
        return out

    collector._act_step = record
    return recorded


def _replay(recorded):
    actions = iter(recorded)
    return lambda *a: torch.tensor(next(actions)).long()


def test_keyed_sample_depends_on_seed_step_and_env_id_only():
    logits = torch.randn(6, 5, generator=torch.Generator().manual_seed(0))
    ids = torch.arange(10, 16)
    whole = keyed_sample(logits, 7, 3, ids)
    parts = torch.cat([keyed_sample(logits[:2], 7, 3, ids[:2]),
                       keyed_sample(logits[2:], 7, 3, ids[2:])])
    assert torch.equal(whole, parts)
    assert torch.equal(keyed_sample(logits[[4, 1]], 7, 3, ids[[4, 1]]), whole[[4, 1]])
    u = keyed_uniform(7, 3, ids, 5)
    assert u.dtype == torch.float64 and bool(((u > 0) & (u < 1)).all())
    assert not torch.equal(u, keyed_uniform(7, 4, ids, 5))
    assert not torch.equal(u, keyed_uniform(8, 3, ids, 5))
    # Gumbel-max: over many steps the frequencies follow the softmax.
    probs = torch.tensor([0.5, 0.3, 0.15, 0.05])
    one = probs.log()[None].expand(16, -1)
    draws = torch.stack([keyed_sample(one, 0, t, torch.arange(16)) for t in range(500)])
    freq = torch.bincount(draws.flatten(), minlength=4).double() / draws.numel()
    assert float((freq - probs.double()).abs().max()) < 0.02


@pytest.fixture(scope="module")
def encoders(tmp_path_factory):
    """JAX's folded clip_rn_tiny f32 encode fn and the port's, from one checkpoint."""
    jenc = jax_build_encoder("clip_rn_tiny", dtype=jnp.float32)
    path = str(tmp_path_factory.mktemp("enc") / "clip_rn_tiny.pt")
    torch.save(from_flax_variables(jax.tree.map(np.asarray, jenc.variables)), path)
    folded = jenc.fold_bn()
    fn = folded.encode_fn()
    jfn = jax.jit(lambda v, f: fn(v, f)["clip_conv"])
    fe, _ = frozen_encode_fn("clip_rn_tiny", torch.float32, device="cpu",
                             torch_checkpoint=path)
    return (lambda frames: jfn(folded.variables, frames)), fe


def test_collect_matches_jax_replay(encoders):
    jencode, fe = encoders
    T, n = 5, 3
    jvenv, venv = _jax_pool(range(n)), VectorEnv(H.hostgrid_fns(range(n)), frame_shape=H.FRAME)
    try:
        jpol = JaxActorCritic(num_actions=6, hidden=32, num_goal_classes=12)
        jcol = JaxCollector(jvenv, jpol, encode_fn=jencode)
        jcol.reset(jax.random.PRNGKey(0))
        obs0 = jcol._policy_obs(jcol._obs, jcol._prev_action)
        params = jpol.init(jax.random.PRNGKey(1), obs0, jpol.initial_state(n),
                           jnp.zeros((n,), bool))["params"]
        recorded = _recording(jcol)
        jr, jlast, jmetrics = jcol.collect(params, T)

        pol = ActorCritic(6, fe.feature_shape, hidden=32, num_goal_classes=12)
        pol.load_state_dict(from_flax_policy_params(C.tree_np(params)))
        col = HostRolloutCollector(venv, pol, encode_fn=fe, device="cpu",
                                   sample_fn=_replay(recorded))
        col.reset(0)
        roll, last, metrics = col.collect(T)
        np.testing.assert_array_equal(col._obs["visual"], jcol._obs["visual"])  # frames
        assert set(roll.obs) == set(jr.obs) == {"visual", "goal", "prev_action"}
        assert roll.obs["visual"].shape == (T, n, 4, 4, 256)
        assert cosine_distance(roll.obs["visual"], np.asarray(jr.obs["visual"])) <= 1e-4
        for k in ("goal", "prev_action"):
            np.testing.assert_array_equal(roll.obs[k].numpy(), np.asarray(jr.obs[k]))
        for f in ("is_start", "actions", "rewards", "dones", "valid", "h0"):
            np.testing.assert_array_equal(getattr(roll, f).numpy(),
                                          np.asarray(getattr(jr, f)), err_msg=f)
        for got, want in ((roll.log_probs, jr.log_probs), (roll.values, jr.values),
                          (last, jlast)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        assert metrics == jmetrics
    finally:
        venv.close()
        jvenv.close()


def test_pipelined_groups_collect_what_one_pool_collects():
    pools = [VectorEnv(H.hostgrid_fns(s), frame_shape=H.FRAME) for s in ((0, 1), (2, 3))]
    whole = VectorEnv(H.hostgrid_fns(range(4)), frame_shape=H.FRAME)
    try:
        out = []
        for venv in (pools, whole):
            pol = ActorCritic(6, (147,), visual_is_map=False, hidden=16)
            col = HostRolloutCollector(venv, pol, encode_fn=H.flat_encode, device="cpu")
            assert col.num_envs == 4
            col.reset(5)
            out.append([col.collect(6), col.collect(3)])  # the second continues the first
        for (r1, l1, m1), (r2, l2, m2) in zip(*out):
            for f in ("is_start", "actions", "rewards", "dones", "valid", "h0"):
                assert torch.equal(getattr(r1, f), getattr(r2, f)), f
            for k in r1.obs:
                assert torch.equal(r1.obs[k], r2.obs[k]), k
            for a, b in ((r1.log_probs, r2.log_probs), (r1.values, r2.values), (l1, l2)):
                torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
            assert m1 == m2
    finally:
        for v in pools + [whole]:
            v.close()


B, T = 5, 4


@pytest.fixture(scope="module")
def case():
    return C.jax_case(batch=B, steps=T)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_host_ppo_update_matches_jax(case, m):
    """Every weight within 1e-6 of JAX's at m = 1 and 3. At m = 2 one GRU input weight's
    gradient falls below 1e-6 in a step (Adam's float32-noise regime), so m = 2 holds the
    weights with `torch_rl_cases.assert_adam_close`: 1e-6 wherever every step's gradient
    is at least 1e-6, 2·lr a step below."""
    jenv, jpol, _, params, _, jr, jlast, _, _ = case
    valid = C.random_valid(T, B, seed=5)
    ppo = dict(epochs=1, lr=3e-4)  # two epochs: test_torch_ddppo.py, the same ppo_update
    jl = JaxHostPPO(H.StubPool(B), jpol, JaxConfig(num_minibatches=m,
                                                  ppo=JaxPPOConfig(**ppo)))
    jp = jax.tree.map(jnp.asarray, params)
    jp, _, jm = jl._update(jp, jl.tx.init(jp), jr._replace(valid=jnp.asarray(valid)), jlast)

    pol = C.port_policy(params)
    learner = HostPPOLearner(H.StubPool(B), pol, DDPPOConfig(
        rollout_len=T, num_minibatches=m, ppo=PPOConfig(**ppo)), device="cpu")
    steps = C.record_steps(learner.tx)
    metrics = learner.update(C.to_port_rollout(jr, valid), C.t(jlast))
    assert learner.tx.count == len(steps) == ppo["epochs"] * m
    for k in jm:
        assert abs(float(metrics[k]) - float(jm[k])) <= 1e-5, k
    want = from_flax_policy_params(C.tree_np(jp))
    if m == 2:
        got = {name: p.detach() for name, p in pol.named_parameters()}
        C.assert_adam_close(got, want, C.min_abs_grads(pol, steps), ppo["lr"], len(steps))
    else:
        for name, p in pol.named_parameters():
            torch.testing.assert_close(p.detach(), want[name], atol=1e-6, rtol=0, msg=name)


def test_two_gloo_processes_with_offsets_equal_one(case):
    """Pools of 3 and 2 envs (offsets 0 and 3) in 2 processes update as one pool of 5."""
    params, jr, jlast = case[3], case[5], case[6]
    roll = C.to_port_rollout(jr, C.random_valid(T, B, seed=3))
    sd = C.port_policy(params).state_dict()
    cfg = DDPPOConfig(rollout_len=T, num_minibatches=3, ppo=PPOConfig(epochs=2, lr=1e-3))
    want_sd, want_m, _ = H.host_update_rank(sd, roll, C.t(jlast), cfg, (B,))
    ranks = dryrun.run_ranks(2, H.host_update_rank, sd, roll, C.t(jlast), cfg, (3, 2),
                             timeout=240)
    for got_sd, got_m, _ in ranks:
        for k in want_sd:
            np.testing.assert_allclose(got_sd[k], want_sd[k], atol=1e-6, rtol=0, err_msg=k)
        for k in want_m:
            assert abs(got_m[k] - want_m[k]) <= 1e-6, k


def test_host_ppo_train_iteration_publishes_stage_timing():
    venv = VectorEnv(H.hostgrid_fns(range(2)), frame_shape=H.FRAME)
    try:
        pol = ActorCritic(6, (147,), visual_is_map=False, hidden=16)
        before = [p.detach().clone() for p in pol.parameters()]
        learner = HostPPOLearner(venv, pol, DDPPOConfig(rollout_len=4, ppo=PPOConfig(
            epochs=1, lr=1e-3)), encode_fn=H.flat_encode, device="cpu")
        learner.init(0)
        for _ in range(2):
            m = learner.train_iteration()
            assert np.isfinite(m["loss"]) and m["env_steps"] == 8
            for k in ("act_s", "env_step_s", "update_s", "act_frac", "env_step_frac",
                      "update_frac", "env_steps_per_s"):
                assert m[k] > 0, k
            assert abs(m["act_frac"] + m["env_step_frac"] + m["update_frac"] - 1) < 1e-6
            assert m["act_calls"] == m["env_step_calls"] == 4 and m["update_calls"] == 1
        assert any(not torch.equal(a, b) for a, b in zip(before, pol.parameters()))
    finally:
        venv.close()


class LockstepEnv:
    """The port's GridNav stepping beside JAX's: each step takes the fresh episodes JAX
    draws for it, and `reset` returns JAX's reset from `key`'s evaluation split."""

    def __init__(self, key, **kw):
        self.env, self.jenv = GridNavEnv(**kw), JaxGridNav(**kw)
        self.num_actions, self.max_steps = self.env.num_actions, self.env.max_steps
        self.key = key
        self.jstep = C.jax_step_with_fresh(self.jenv)

    def reset(self, generator, batch):
        _, kr = jax.random.split(self.key)
        self.js, _ = jax.jit(self.jenv.reset, static_argnums=1)(kr, batch)
        state = C.to_port_state(self.js)
        return state, self.env.observe(state)

    def step(self, state, action, generator):
        (self.js, *_), fresh = self.jstep(self.js, action.numpy().astype(np.int32))
        stepped, reward, done, info = self.env.advance(state, action)
        new = self.env.auto_reset(stepped, done, fresh)
        return new, self.env.observe(new), reward, done, info


def test_evaluate_policy_matches_jax(case):
    jenv, jpol, params = case[0], case[1], case[3]
    key = jax.random.PRNGKey(4)
    jeps = jax_evaluate.evaluate_policy(jenv, jpol.apply, jax.tree.map(jnp.asarray, params),
                                        key, num_episodes=7, hidden=C.HIDDEN, env_batch=3,
                                        max_steps_total=256)
    eps = evaluate.evaluate_policy(LockstepEnv(key, **C.ENV_KW), C.port_policy(params),
                                   torch.Generator(), num_episodes=7, env_batch=3,
                                   max_steps_total=256)
    assert len(eps) == 7 and eps == jeps


def test_evaluate_policy_host_matches_jax(tmp_path):
    n, kw = 3, dict(max_steps=10)
    jvenv = _jax_pool(range(n), **kw)
    venv = VectorEnv(H.hostgrid_fns(range(n), **kw), frame_shape=H.FRAME, max_steps=10)
    try:
        jpol = JaxActorCritic(num_actions=6, hidden=32, visual_is_map=False)

        def jencode(frames):
            return (frames[:, ::8, ::8].astype(jnp.float32) / 255.0).reshape(n, -1)

        obs = {"visual": jnp.zeros((n, 147)), "goal": jnp.zeros((n,), jnp.int32),
               "prev_action": jnp.zeros((n,), jnp.int32)}
        params = jpol.init(jax.random.PRNGKey(2), obs, jpol.initial_state(n),
                           jnp.ones((n,), bool))["params"]
        jeps = jax_evaluate.evaluate_policy_host(
            jvenv, jpol.apply, params, jax.random.PRNGKey(0), num_episodes=8, hidden=32,
            num_actions=6, encode_fn=jencode, max_steps_total=200)
        pol = ActorCritic(6, (147,), visual_is_map=False, hidden=32)
        pol.load_state_dict(from_flax_policy_params(C.tree_np(params)))
        eps = evaluate.evaluate_policy_host(venv, pol, num_episodes=8, num_actions=6,
                                            encode_fn=H.flat_encode, max_steps_total=200,
                                            device="cpu")
        assert len(eps) == 8 and eps == jeps
        path = evaluate.write_metrics_json(str(tmp_path / "metrics.json"), eps)
        jpath = jax_evaluate.write_metrics_json(str(tmp_path / "jax.json"), jeps)
        assert open(path).read() == open(jpath).read()
        for cls in {e["task_info"]["object_type"] for e in eps} | {"none"}:
            assert evaluate.compute_scores(path, cls) == jax_evaluate.compute_scores(jpath, cls)
    finally:
        venv.close()
        jvenv.close()


def test_stage_timer_and_trace(tmp_path):
    """`StageTimer` sums seconds, shares and calls per stage; `trace` writes a
    torch.profiler trace of its block."""
    import os

    from embodied_clip_tpu_torch.utils.profiling import StageTimer, trace

    timer = StageTimer()
    for name in ("act", "act", "update"):
        with timer.stage(name):
            torch.ones(64, 64) @ torch.ones(64, 64)
    s = timer.summary()
    assert s["act_calls"] == 2 and s["update_calls"] == 1
    assert abs(s["act_frac"] + s["update_frac"] - 1) < 1e-9 and s["act_s"] > 0
    timer.reset()
    assert timer.summary() == {}
    with trace(str(tmp_path)):
        torch.ones(8) + 1
    assert any(f.endswith(".json") or f.endswith(".json.gz") for f in os.listdir(tmp_path))
