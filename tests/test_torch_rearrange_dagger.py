"""The port's rearrangement envs and DAgger (`embodied_clip_tpu_torch/envs/rearrange.py`,
`training/dagger.py`) against the JAX package's, on the CPU.

- `GridRearrangeEnv` and `GridTwoPhaseRearrangeEnv` bit-equal to JAX's over 60 steps
  (half of them the expert's) when JAX's draws are injected (its fresh episodes, and the
  2-phase switch's teleports): states, observations, rewards, dones, infos and experts;
- `supervised_step` (the update of `DAggerLearner` and `HostDAggerLearner`) against
  JAX's `_sup_step` on a JAX DAgger rollout, with and without the taint weights: the
  weights after the step within 1e-6 wherever the gradient is at least 1e-6 (below,
  Adam's first step is set by float32 noise: `_assert_update`), loss and accuracy
  within 1e-5 (the metrics' tolerance of `tests/test_torch_ddppo.py`);
- `HostRolloutCollector.collect_dagger` over the port's `VectorEnv` of
  `THORRearrangeEnv` (the scripted controller, both views) against JAX's over JAX's
  pool (both views through a flat stand-in encoder), replaying JAX's learner actions:
  observations, starts, experts, weights and episode metrics equal; then one weighted
  update of each, held as above;
- the port's `HostDAggerLearner.train_iteration` runs with the aggregate (JAX's unpacks
  5 of `collect_dagger`'s 6 values and cannot), and the taint mask of a transition
  fabricated at a call's last step reaches the next call's step 0;
- `DAggerLearner.train_iteration` on both envs, with and without the aggregate.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_clip_tpu.envs import rearrange as jax_rearrange
from embodied_clip_tpu.envs.thor_rearrange import THORRearrangeEnv as JaxTHORRearrange
from embodied_clip_tpu.envs.vector import VectorEnv as JaxVectorEnv
from embodied_clip_tpu.models.policy import ActorCritic as JaxActorCritic
from embodied_clip_tpu.training.dagger import DAggerConfig as JaxDAggerConfig
from embodied_clip_tpu.training.dagger import DAggerLearner as JaxDAggerLearner
from embodied_clip_tpu.training.dagger import HostDAggerLearner as JaxHostDAgger

from embodied_clip_tpu_torch.envs import rearrange
from embodied_clip_tpu_torch.envs.vector import VectorEnv
from embodied_clip_tpu_torch.models.convert import from_flax_policy_params
from embodied_clip_tpu_torch.models.policy import ActorCritic
from embodied_clip_tpu_torch.training.dagger import (
    DAggerConfig,
    DAggerLearner,
    HostDAggerLearner,
    supervised_step,
)
from embodied_clip_tpu_torch.training.host_rollout import HostRolloutCollector
from embodied_clip_tpu_torch.training.optim import ClippedAdam

import torch_host_cases as H
from fake_thor import FakeController
from torch_rl_cases import assert_adam_close, tree_np
from torch_rl_cases import t as tt

B = 4
KW = dict(size=5, max_steps=12)


def _to_port(state_cls, js):
    return state_cls(**{f.name: tt(getattr(js, f.name)) for f in dataclasses.fields(state_cls)})


def _jax_draws(jenv, two_phase):
    """A jitted fn (JAX state, action) → (JAX's step outputs, its fresh episodes as
    arrays, and for 2-phase the phase switch's teleports)."""
    def fn(js, a):
        key = js.key
        shuffle = None
        if two_phase:
            ks = jax.vmap(lambda k: jax.random.split(k, 4))(js.key)
            rand2 = jax.vmap(lambda k: jax.random.randint(k, (2,), 0, jenv.size))
            shuffle = (rand2(ks[:, 0]).astype(jnp.int32), rand2(ks[:, 1]).astype(jnp.int32),
                       jax.vmap(lambda k: jax.random.randint(k, (), 0, 4))(ks[:, 2])
                       .astype(jnp.int32))
            is_walk = js.phase == 0
            end_walk = is_walk & ((a == jax_rearrange.DROP)
                                  | (js.walk_t + 1 >= jenv.walkthrough_budget))
            key = jnp.where(end_walk[:, None], ks[:, 3], js.key)
        nxt = jax.vmap(lambda k: jax.random.split(k, 2))(key)
        return jenv.step(js, a), jax.vmap(jenv._init_episode)(nxt[:, 0]), shuffle

    return jax.jit(fn)


@pytest.mark.parametrize("two_phase", [False, True])
def test_grid_rearrange_matches_jax_with_injected_draws(two_phase):
    if two_phase:
        env = rearrange.GridTwoPhaseRearrangeEnv(walkthrough_budget=6, **KW)
        jenv = jax_rearrange.GridTwoPhaseRearrangeEnv(walkthrough_budget=6, **KW)
        cls = rearrange.GridTwoPhaseState
    else:
        env, jenv = rearrange.GridRearrangeEnv(**KW), jax_rearrange.GridRearrangeEnv(**KW)
        cls = rearrange.GridRearrangeState
    js, jobs = jax.jit(jenv.reset, static_argnums=1)(jax.random.PRNGKey(0), B)
    state = _to_port(cls, js)
    for k, v in env.observe(state).items():
        assert torch.equal(v, tt(jobs[k])), k
    step = _jax_draws(jenv, two_phase)
    rng = np.random.RandomState(1)
    dones = 0
    for t in range(60):
        expert = env.expert_action(state)
        assert torch.equal(expert, tt(jenv.expert_action(js))), t
        action = torch.where(torch.from_numpy(rng.rand(B) < 0.5), expert,
                             torch.from_numpy(rng.randint(0, 5, B).astype(np.int32)))
        (js, jobs, jr, jd, jinfo), init, shuffle = step(js, jnp.asarray(action.numpy()))
        if two_phase:
            agent, adir, goal = (tt(x) for x in init)
            z = torch.zeros(B, dtype=torch.int32)
            fresh = cls(agent_pos=agent, agent_dir=adir, obj_pos=goal, goal_pos=goal,
                        holding=z.bool(), t=z, walk_t=z, phase=z, best_len=z + 1)
            stepped, r, d, info = env.advance(state, action, tuple(tt(x) for x in shuffle))
        else:
            agent, adir, obj, goal, best = (tt(x) for x in init)
            fresh = cls(agent_pos=agent, agent_dir=adir, obj_pos=obj, goal_pos=goal,
                        holding=torch.zeros(B, dtype=torch.bool),
                        t=torch.zeros(B, dtype=torch.int32), best_len=best)
            stepped, r, d, info = env.advance(state, action)
        state = env.auto_reset(stepped, d, fresh)
        for f in dataclasses.fields(cls):
            assert torch.equal(getattr(state, f.name), tt(getattr(js, f.name))), (t, f.name)
        for k, v in env.observe(state).items():
            assert torch.equal(v, tt(jobs[k])), (t, k)
        assert torch.equal(r, tt(jr)) and torch.equal(d, tt(jd)), t
        for k in info:
            assert torch.equal(info[k], tt(jinfo[k])), (t, k)
        dones += int(d.sum())
    assert dones >= 3


@pytest.fixture(scope="module")
def jax_dagger_case():
    """A JAX on-device DAgger learner (GridRearrange, map policy, hidden 32) with its
    params and optimizer state, and a 6-step expert rollout of 4 envs, observed as its
    collector observes (the port's env, bit-equal to JAX's by the test above), with a
    nonzero entering hidden state."""
    jenv = jax_rearrange.GridRearrangeEnv(**KW)
    jpol = JaxActorCritic(num_actions=5, hidden=32, num_goal_classes=12)
    learner = JaxDAggerLearner(jenv, jpol, JaxDAggerConfig(rollout_len=6, env_batch=B,
                                                           lr=1e-3))
    env, gen = rearrange.GridRearrangeEnv(**KW), torch.Generator().manual_seed(2)
    state, obs = env.reset(gen, B)
    prev, start = torch.full((B,), env.num_actions), torch.ones(B, dtype=torch.bool)
    seq, starts, experts = [], [], []
    for _ in range(6):
        expert = env.expert_action(state).long()
        seq.append({**obs, "prev_action": prev.int()})
        starts.append(start)
        experts.append(expert.int())
        state, obs, _, start, _ = env.step(state, expert, gen)
        prev = torch.where(start, env.num_actions, expert)
    obs_seq = {k: np.stack([s[k].numpy() for s in seq]) for k in seq[0]}
    starts, expert_seq = np.stack(starts), np.stack(experts)
    h0 = (0.1 * np.random.RandomState(0).randn(B, 32)).astype(np.float32)
    params = jpol.init(jax.random.PRNGKey(2), {k: jnp.asarray(v[0]) for k, v in obs_seq.items()},
                       jnp.asarray(h0), jnp.asarray(starts[0]))["params"]
    return learner, tree_np(params), learner.tx.init(params), (obs_seq, h0, starts,
                                                               expert_seq)


def _port_map_policy(params, num_actions=5):
    pol = ActorCritic(num_actions, (7, 7, 4), hidden=32, num_goal_classes=12)
    pol.load_state_dict(from_flax_policy_params(params))
    return pol


def _assert_update(pol, jparams, lr):
    """The weights after one step within 1e-6 of JAX's wherever the port's gradient (left
    in `.grad` by `supervised_step`) is at least 1e-6, within 2·lr below
    (`torch_rl_cases.assert_adam_close`)."""
    got = {name: p.detach() for name, p in pol.named_parameters()}
    # The critic has no loss here, so no gradient.
    grads = {name: (p.grad if p.grad is not None else torch.zeros_like(p)).abs()
             for name, p in pol.named_parameters()}
    assert_adam_close(got, from_flax_policy_params(tree_np(jparams)), grads, lr, 1)


@pytest.mark.parametrize("weighted", [False, True])
def test_supervised_step_matches_jax(jax_dagger_case, weighted):
    learner, params, opt, (obs_seq, h0, starts, expert_seq) = jax_dagger_case
    weights = (np.random.RandomState(4).rand(*starts.shape) > 0.3).astype(np.float32)
    jw = (jnp.asarray(weights),) if weighted else ()
    opt = jax.tree.map(jnp.array, opt)  # a copy: `_sup_step` donates it
    jp, _, jl, ja = learner._sup_step(jax.tree.map(jnp.asarray, params), opt, obs_seq, h0,
                                      starts, expert_seq, *jw)
    pol = _port_map_policy(params)
    tx = ClippedAdam(pol.parameters(), 1e-3, 0.5)
    loss, acc = supervised_step(pol, tx, {k: tt(v) for k, v in obs_seq.items()}, tt(h0),
                                tt(starts), tt(expert_seq).long(),
                                torch.from_numpy(weights) if weighted else None)
    assert abs(loss - float(jl)) <= 1e-5 and abs(acc - float(ja)) <= 1e-5
    _assert_update(pol, jp, 1e-3)


def _jax_flat_encode(frames):
    """`torch_host_cases.flat_encode` in JAX."""
    return (frames[:, ::8, ::8].astype(jnp.float32) / 255.0).reshape(frames.shape[0], -1)


def _jax_rearrange_fns(seeds):
    return [functools.partial(JaxTHORRearrange, scenes=["FakeScene_1"],
                              controller_factory=FakeController, width=H.THOR_PX,
                              height=H.THOR_PX, num_misplaced=1, num_toggled_open=0,
                              max_steps=40, visibility_distance=1.5, seed=s) for s in seeds]


def test_collect_dagger_and_update_match_jax():
    T, n, frame = 8, 3, (H.THOR_PX, H.THOR_PX, 3)
    jvenv = JaxVectorEnv(_jax_rearrange_fns(range(10, 10 + n)), frame_shape=frame)
    venv = VectorEnv(H.rearrange_fns(range(10, 10 + n)), frame_shape=frame)
    try:
        # A flat encode (every 8th pixel of each view) and a Dense-front policy: the
        # views' concat is what is compared; XLA's CPU conv backward is slow.
        jpol = JaxActorCritic(num_actions=10, goal_kind="none", hidden=32,
                              visual_is_map=False)
        jl = JaxHostDAgger(jvenv, jpol, JaxDAggerConfig(rollout_len=T, lr=1e-3),
                           encode_fn=_jax_flat_encode)
        params, opt = jl.init(jax.random.PRNGKey(0))
        recorded, act_step = [], jl.collector._act_step

        def record(*args):
            out = act_step(*args)
            recorded.append(np.asarray(out[0]))
            return out

        jl.collector._act_step = record
        jout = jl.collector.collect_dagger(params, T, 0.5, np.random.RandomState(0))
        jobs, jh0, jstarts, jexp, jw, jmetrics = jout

        pol = ActorCritic(10, (2 * 192,), goal_kind="none", hidden=32, visual_is_map=False)
        pol.load_state_dict(from_flax_policy_params(tree_np(params)))
        replay = iter(recorded)
        learner = HostDAggerLearner(venv, pol, DAggerConfig(rollout_len=T, lr=1e-3),
                                    encode_fn=H.flat_encode, device="cpu",
                                    sample_fn=lambda *a: torch.tensor(next(replay)).long())
        learner.init(0)
        obs, h0, starts, experts, weights, metrics = learner.collector.collect_dagger(
            T, 0.5, np.random.RandomState(0))
        assert set(obs) == set(jobs) == {"visual", "goal", "prev_action"}
        assert obs["visual"].shape == (T, n, 2 * 192)  # both views, concatenated
        for k in obs:
            np.testing.assert_array_equal(obs[k].numpy(), np.asarray(jobs[k]), err_msg=k)
        for got, want in ((h0, jh0), (starts, jstarts), (experts, jexp), (weights, jw)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert metrics == jmetrics

        jp, _, jloss, jacc = jl._sup_step(params, opt, jobs, jh0, jstarts, jexp, jw)
        loss, acc = supervised_step(pol, learner.tx, obs, h0, starts, experts, weights)
        assert abs(loss - float(jloss)) <= 1e-5 and abs(acc - float(jacc)) <= 1e-5
        _assert_update(pol, jp, 1e-3)

        # The port's train_iteration runs (with the aggregate), JAX's cannot.
        learner = HostDAggerLearner(venv, pol, DAggerConfig(
            rollout_len=4, lr=1e-3, beta_decay_iters=4, aggregate_size=2),
            encode_fn=H.flat_encode, device="cpu")
        learner.init(0)
        for it in range(3):
            m = learner.train_iteration(it)
            assert np.isfinite(m["loss"]) and 0.0 <= m["expert_match"] <= 1.0
        assert m["beta"] == pytest.approx(0.5) and len(learner.aggregate.items) == 2
        assert m["aggregate_rollouts"] == 2
        for k in ("act_s", "env_step_s", "update_s", "env_steps_per_s"):
            assert m[k] > 0, k
    finally:
        venv.close()
        jvenv.close()


def test_collect_dagger_carries_the_taint_across_calls():
    """A transition fabricated at the last step of one call masks that env's pair at
    step 0 of the next call (the JAX package resets the mask every call)."""
    T = 3
    venv = H.ScriptedVenv(3, bad=1, invalid_at={T - 1})
    pol = ActorCritic(6, (147,), visual_is_map=False, hidden=16)
    col = HostRolloutCollector(venv, pol, device="cpu",
                               encode_fn=lambda f: f[:, ::8, ::8].float().flatten(1) / 255)
    col.reset(0)
    rng = np.random.RandomState(0)
    w1 = col.collect_dagger(T, 0.5, rng)[4]
    w2 = col.collect_dagger(T, 0.5, rng)[4]
    assert bool((w1 == 1).all())
    want = torch.ones(T, 3)
    want[0, 1] = 0
    assert torch.equal(w2, want)


@pytest.mark.parametrize("two_phase,aggregate", [(False, 0), (True, 2)])
def test_dagger_learner_trains(two_phase, aggregate):
    env = (rearrange.GridTwoPhaseRearrangeEnv(walkthrough_budget=6, **KW) if two_phase
           else rearrange.GridRearrangeEnv(**KW))
    pol = ActorCritic(5, (7, 7, 4), hidden=32, num_goal_classes=2 if two_phase else 12)
    learner = DAggerLearner(env, pol, DAggerConfig(rollout_len=8, env_batch=B, lr=1e-3,
                                                   epochs=2, beta_decay_iters=4,
                                                   aggregate_size=aggregate), device="cpu")
    gen = torch.Generator().manual_seed(0)
    act = learner.init(gen)
    before = [p.detach().clone() for p in pol.parameters()]
    for it in range(3):
        act, m = learner.train_iteration(act, it, gen)
        assert np.isfinite(m["loss"]) and 0.0 <= m["expert_match"] <= 1.0
    assert m["beta"] == pytest.approx(0.5)
    assert any(not torch.equal(a, b) for a, b in zip(before, pol.parameters()))
    if aggregate:
        assert m["aggregate_rollouts"] == 2
