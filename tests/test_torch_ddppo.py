"""The port's DD-PPO learner, rollout, data-parallel update and frames path
(`embodied_clip_tpu_torch/training/`, `parallel/`) against the JAX package's, on the CPU.

- `DDPPOLearner.update` against the JAX loop rebuilt from its public parts
  (`compute_gae`, `iter_minibatches`, `ppo_loss`, `learner.tx`, as at
  `embodied_clip_tpu/training/ddppo.py:126-143`), m = 1 and m = 3 over an uneven B = 5:
  the last minibatch's metrics within 1e-5, every weight within 1e-6;
- `collect_rollout` against JAX's, replaying JAX's actions and fresh episodes: states,
  observations, actions, rewards and dones equal, log-probs, values and the bootstrap
  value within 1e-5;
- 2 gloo processes against 1 on the same rollout (m = 1 and m = 3, uneven B, a `valid`
  mask): weights and metrics within 1e-6;
- `parallel.dryrun.dryrun_multichip(2)` ends ok;
- the frozen encoder inside the rollout (M7): `frozen_encode_fn("clip_rn_tiny", f32)` on
  frames the env rendered within 1e-4 cosine of the JAX encoder (the f32 limit of
  `tests/test_torch_encoder.py`), then one iteration with it inside the rollout;
- a slow-tier learning gate mirroring `tests/test_rl.py:76-101`, over seeds 0-4 at 1 and
  8 threads (median late success), beside the JAX package's runs from the same seeds.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from embodied_clip_tpu.models.encoders import build_encoder as jax_build_encoder
from embodied_clip_tpu.training.ddppo import DDPPOConfig as JaxConfig
from embodied_clip_tpu.training.ddppo import DDPPOLearner as JaxLearner
from embodied_clip_tpu.training.ddppo import iter_minibatches as jax_minibatches
from embodied_clip_tpu.training.ppo import PPOConfig as JaxPPOConfig
from embodied_clip_tpu.training.ppo import compute_gae as jax_gae
from embodied_clip_tpu.training.ppo import ppo_loss as jax_loss

from embodied_clip_tpu_torch.envs.gridworld import GridNavEnv
from embodied_clip_tpu_torch.models.convert import from_flax_policy_params, from_flax_variables
from embodied_clip_tpu_torch.models.policy import ActorCritic
from embodied_clip_tpu_torch.parallel import dryrun
from embodied_clip_tpu_torch.parity import cosine_distance
from embodied_clip_tpu_torch.training.ddppo import DDPPOConfig, DDPPOLearner, iter_minibatches
from embodied_clip_tpu_torch.training.frames import frozen_encode_fn
from embodied_clip_tpu_torch.training.ppo import PPOConfig
from embodied_clip_tpu_torch.training.rollout import ActState, collect_rollout

import torch_rl_cases as C

B, T = 5, 4


@pytest.fixture(scope="module")
def case():
    return C.jax_case(batch=B, steps=T)


@pytest.mark.parametrize("m", [1, 3])
def test_update_matches_jax_loop(case, m):
    jenv, jpol, _, params, _, jr, jlast, _, _ = case
    ppo = dict(epochs=2, lr=3e-4)
    tx = JaxLearner(jenv, jpol, JaxConfig(ppo=JaxPPOConfig(**ppo))).tx
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    adv, ret = jax_gae(jr.rewards, jr.values, jr.dones, jlast, 0.99, 0.95)
    @jax.jit
    def step(p, state, mb, a, r):
        (_, metrics), g = jax.value_and_grad(jax_loss, has_aux=True)(
            p, jpol.apply, mb, a, r, JaxPPOConfig(**ppo))
        upd, state = tx.update(g, state, p)
        return optax.apply_updates(p, upd), state, metrics

    sizes = []
    for _ in range(ppo["epochs"]):
        for mb, a, r in jax_minibatches(m, jr, adv, ret):
            sizes.append(mb.actions.shape[1])
            jp, state, jm = step(jp, state, mb, a, r)
    assert sizes == ([5, 5] if m == 1 else [2, 2, 1] * 2)

    pol = C.port_policy(params)
    learner = DDPPOLearner(GridNavEnv(**C.ENV_KW), pol, DDPPOConfig(
        rollout_len=T, env_batch=B, num_minibatches=m, ppo=PPOConfig(**ppo)), device="cpu")
    metrics = learner.update(C.to_port_rollout(jr), C.t(jlast))
    assert learner.tx.count == len(sizes)
    for k in jm:
        assert abs(float(metrics[k]) - float(jm[k])) <= 1e-5, k
    want = from_flax_policy_params(C.tree_np(jp))
    for name, p in pol.named_parameters():
        torch.testing.assert_close(p.detach(), want[name], atol=1e-6, rtol=0, msg=name)


def test_iter_minibatches_matches_jax(case):
    jr = case[5]
    adv = np.arange(T * B, dtype=np.float32).reshape(T, B)
    for m in (1, 2, 3, 5, 7):
        got = [(mb.actions.numpy(), a.numpy(), r.numpy(), mb.h0.numpy()) for mb, a, r in
               iter_minibatches(m, C.to_port_rollout(jr), torch.from_numpy(adv),
                                torch.from_numpy(adv + 1))]
        want = list(jax_minibatches(m, jr, jnp.asarray(adv), jnp.asarray(adv + 1)))
        assert len(got) == len(want)
        for g, (mb, a, r) in zip(got, want):
            for x, y in zip(g, (mb.actions, a, r, mb.h0)):
                np.testing.assert_array_equal(x, np.asarray(y))


class ReplayEnv:
    """The port's env, stepping with the fresh episodes JAX drew at each step."""

    def __init__(self, env, fresh):
        self.env, self.fresh, self.t = env, fresh, 0
        self.num_actions = env.num_actions

    def step(self, state, action, generator):
        stepped, reward, done, info = self.env.advance(state, action)
        new = self.env.auto_reset(stepped, done, self.fresh[self.t])
        self.t += 1
        return new, self.env.observe(new), reward, done, info


def test_collect_rollout_matches_jax_replay(case):
    jenv, _, _, params, jact, jr, jlast, jact2, jmetrics = case
    # Step JAX's env again with the rollout's actions to recover each step's fresh
    # episodes (drawn from the env state's keys).
    step = C.jax_step_with_fresh(jenv)
    js, fresh = jact.env_state, []
    for t in range(T):
        (js, *_), f = step(js, np.asarray(jr.actions[t]))
        fresh.append(f)
    actions = iter(C.t(jr.actions).long())
    env = GridNavEnv(**C.ENV_KW)
    act = ActState(env_state=C.to_port_state(jact.env_state),
                   obs={k: C.t(v) for k, v in jact.obs.items()}, h=C.t(jact.h),
                   prev_action=C.t(jact.prev_action).long(), is_start=C.t(jact.is_start))
    roll, last, act2, metrics = collect_rollout(
        ReplayEnv(env, fresh), C.port_policy(params), act, T, torch.Generator(),
        sample_fn=lambda logits, gen: next(actions))
    want = C.to_port_rollout(jr)
    assert set(roll.obs) == set(want.obs) == {"visual", "goal", "prev_action"}
    for k in roll.obs:
        assert torch.equal(roll.obs[k], want.obs[k].to(roll.obs[k].dtype)), k
    for f in ("is_start", "actions", "rewards", "dones", "h0"):
        assert torch.equal(getattr(roll, f), getattr(want, f)), f
    for got, ref in ((roll.log_probs, want.log_probs), (roll.values, want.values),
                     (last, C.t(jlast)), (act2.h, C.t(jact2.h))):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    for f in dataclasses.fields(act2.env_state):
        assert torch.equal(getattr(act2.env_state, f.name), C.t(getattr(jact2.env_state, f.name)))
    assert torch.equal(act2.prev_action, C.t(jact2.prev_action).long())
    assert torch.equal(act2.is_start, C.t(jact2.is_start))
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        assert abs(float(metrics[k]) - float(jmetrics[k])) <= 1e-5, k


@pytest.mark.parametrize("m", [1, 3])
def test_two_gloo_ranks_match_one(case, m):
    """The same global rollout (B = 5: ranks own 3 and 2 envs, and with m = 3 rank 0 has
    no share of the last minibatch) with a straggler mask, updated in 2 processes and in
    1: the global statistics and the summed gradients give the one-process update."""
    params, jr, jlast = case[3], case[5], case[6]
    roll = C.to_port_rollout(jr, C.random_valid(T, B, seed=3))
    sd = C.port_policy(params).state_dict()
    cfg = DDPPOConfig(rollout_len=T, env_batch=B, num_minibatches=m,
                      ppo=PPOConfig(epochs=2, lr=1e-3))
    want_sd, want_m = C.update_rank(sd, roll, C.t(jlast), cfg)
    ranks = dryrun.run_ranks(2, C.update_rank, sd, roll, C.t(jlast), cfg, timeout=240)
    for got_sd, got_m in ranks:
        for k in want_sd:
            np.testing.assert_allclose(got_sd[k], want_sd[k], atol=1e-6, rtol=0, err_msg=k)
        for k in want_m:
            assert abs(got_m[k] - want_m[k]) <= 1e-6, k
    assert all(np.array_equal(ranks[0][0][k], ranks[1][0][k]) for k in want_sd)


def test_dryrun_multichip_two_processes(capsys):
    dryrun.dryrun_multichip(2)
    assert "dryrun_multichip(2): ok, loss=" in capsys.readouterr().out


def test_frozen_encoder_inside_the_rollout(tmp_path):
    """M7: the frames the env renders go through `frozen_encode_fn`'s encoder (the JAX
    encoder's weights, from a torch checkpoint) as through the JAX encoder; then one
    DD-PPO iteration with it inside the rollout trains the conv-map policy."""
    jenc = jax_build_encoder("clip_rn_tiny", dtype=jnp.float32)
    path = str(tmp_path / "clip_rn_tiny.pt")
    torch.save(from_flax_variables(jax.tree.map(np.asarray, jenc.variables)), path)
    fe, visual_is_map = frozen_encode_fn("clip_rn_tiny", torch.float32, device="cpu",
                                         torch_checkpoint=path)
    assert visual_is_map and fe.key == "clip_conv" and fe.feature_shape == (4, 4, 256)
    env = GridNavEnv(size=5, max_steps=8, frame_obs=True)
    _, obs = env.reset(torch.Generator().manual_seed(0), 3)
    frames = obs["visual"]
    assert frames.dtype == torch.uint8 and frames.shape == (3, 56, 56, 3)
    want = jenc.fold_bn().encode(frames.numpy())["clip_conv"]
    assert cosine_distance(fe(frames), np.asarray(want, np.float32)) <= 1e-4

    policy = ActorCritic(env.num_actions, fe.feature_shape, hidden=32)
    before = [p.detach().clone() for p in policy.parameters()]
    learner = DDPPOLearner(env, policy, DDPPOConfig(rollout_len=2, env_batch=2,
                                                    ppo=PPOConfig(epochs=1)),
                           encode_fn=fe, device="cpu")
    gen = torch.Generator().manual_seed(1)
    act = learner.init(gen)
    act, metrics = learner.train_iteration(act, gen)
    assert np.isfinite(float(metrics["loss"]))
    assert any(not torch.equal(a, b) for a, b in zip(before, policy.parameters()))


LEARN_SEEDS = range(5)
LEARN_CONFIG = dict(rollout_len=32, env_batch=16)
LEARN_PPO = dict(lr=3e-3, epochs=4, entropy_coef=0.01)


def _port_learning(seed):
    """(success at iteration 4, best success over iterations 40-79) of the port's run of
    `tests/test_rl.py::test_ddppo_learns_gridworld`'s setting from `seed`."""
    env = GridNavEnv(size=5, max_steps=24, flat_obs=True)
    policy = ActorCritic(env.num_actions, (env.view * env.view * env.obs_channels,),
                         goal_kind="object_embed", num_goal_classes=env.num_classes,
                         hidden=64, visual_is_map=False)
    learner = DDPPOLearner(env, policy, DDPPOConfig(**LEARN_CONFIG, ppo=PPOConfig(**LEARN_PPO)),
                           device="cpu")
    gen = torch.Generator().manual_seed(seed)
    act = learner.init(gen)
    hist = []
    for _ in range(80):
        act, m = learner.train_iteration(act, gen)
        hist.append(float(m["success"]))
    return hist[4], max(hist[40:])


@pytest.fixture(scope="module")
def jax_learning():
    """The JAX package's run of the same setting from the same seeds (its own RNG, so
    not the same trajectories), at XLA's default thread count: the reference beside
    which the port's spread across seeds is read."""
    from embodied_clip_tpu.envs.gridworld import GridNavEnv as JaxEnv
    from embodied_clip_tpu.models.policy import ActorCritic as JaxPolicy

    runs = []
    for seed in LEARN_SEEDS:
        env = JaxEnv(size=5, max_steps=24, flat_obs=True)
        policy = JaxPolicy(num_actions=env.num_actions, goal_kind="object_embed",
                           num_goal_classes=env.num_classes, hidden=64, visual_is_map=False)
        learner = JaxLearner(env, policy, JaxConfig(**LEARN_CONFIG,
                                                    ppo=JaxPPOConfig(**LEARN_PPO)))
        params, opt_state, act = learner.init(jax.random.PRNGKey(seed))
        hist = []
        for _ in range(80):
            params, opt_state, act, m = learner.train_iteration(params, opt_state, act)
            hist.append(float(m["success"]))
        runs.append((hist[4], max(hist[40:])))
    return runs


@pytest.mark.slow
@pytest.mark.parametrize("threads", [1, 8])
def test_ddppo_learns_gridworld(threads, jax_learning):
    """The port's counterpart of `tests/test_rl.py::test_ddppo_learns_gridworld`: the
    flat-obs policy learns the size-5 gridworld. Recurrent PPO on this task is chaotic
    (the CPU kernels' summation order, which follows the thread count, moves the
    trajectory), so the gate is over seeds 0-4 at 1 and 8 threads: the median late
    success above the JAX test's 0.45, and the median gain over iteration 4 above 0.
    Prints each seed's (iteration 4, late) beside the JAX package's."""
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        runs = [_port_learning(seed) for seed in LEARN_SEEDS]
    finally:
        torch.set_num_threads(before)
    for seed, (first, late), (jfirst, jlate) in zip(LEARN_SEEDS, runs, jax_learning):
        print(f"seed {seed}, {threads} thread(s): port {first:.4f} -> {late:.4f}; "
              f"JAX {jfirst:.4f} -> {jlate:.4f}")
    late = [b for _, b in runs]
    print(f"{threads} thread(s): port median late {np.median(late):.4f}, "
          f"{sum(x > 0.45 for x in late)}/{len(late)} above 0.45; JAX median late "
          f"{np.median([b for _, b in jax_learning]):.4f}, "
          f"{sum(b > 0.45 for _, b in jax_learning)}/{len(late)} above 0.45")
    assert np.median(late) > 0.45, runs
    assert np.median([b - a for a, b in runs]) > 0, runs


@pytest.mark.parametrize("extra", [[], ["--frames", "--encoder", "clip_rn_tiny", "--int8"]])
def test_train_objectnav_example_runs_on_the_cpu(capsys, extra):
    from embodied_clip_tpu_torch.examples import train_objectnav

    train_objectnav.main(["--device", "cpu", "--iters", "1", "--env-batch", "2",
                          "--rollout", "2"] + extra)
    assert "final: success=" in capsys.readouterr().out


def test_one_process_needs_no_group(monkeypatch):
    """Without a coordinator one process is no group, and the helpers are the identity;
    a multi-process run without its rendezvous variables raises."""
    from embodied_clip_tpu_torch.parallel import mesh
    from embodied_clip_tpu_torch.parallel.distributed import initialize_distributed

    for var in ("ECT_COORDINATOR", "ECT_NUM_PROCESSES", "ECT_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed(device="cpu") is False
    assert mesh.world_size() == 1 and mesh.shard_batch(5) == slice(0, 5)
    x = torch.arange(3.0)
    assert mesh.all_sum(x) is x
    assert mesh.split_sizes(5, 2) == [3, 2] and mesh.split_sizes(2, 3) == [1, 1, 0]
    monkeypatch.setenv("ECT_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="ECT_COORDINATOR"):
        initialize_distributed(device="cpu")
