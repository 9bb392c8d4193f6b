"""Zero-shot ObjectNav in the port (`embodied_clip_tpu_torch/zeroshot`,
`config/rl_experiments._GoalMappedEnv`) against the JAX package's, on the CPU.

Tolerances:
- `text_goal_table` of the JAX CLIP's weights carried across within 1e-5 of JAX's table
  (unit rows of two f32 towers that agree to ~1e-6 at this size), rows of unit norm
  within 1e-6;
- `seen_unseen_class_ids` equal;
- one zero-shot `collect_rollout` through `_GoalMappedEnv`, JAX's actions and fresh
  episodes replayed (`tests/test_torch_ddppo.py`'s pattern): states, frames-free
  observations (the goal embeddings included), actions, rewards and dones equal;
  log-probs, values and the bootstrap value within 1e-5, as that test holds them;
- `evaluate_policy` with the goal map names each record's class.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_clip_tpu.config.rl_experiments import _GoalMappedEnv as JaxGoalMappedEnv
from embodied_clip_tpu.envs.gridworld import GridNavEnv as JaxEnv
from embodied_clip_tpu.models.policy import ActorCritic as JaxActorCritic
from embodied_clip_tpu.models.tokenizer import SimpleTokenizer as JaxTokenizer
from embodied_clip_tpu.training.ddppo import DDPPOConfig as JaxConfig
from embodied_clip_tpu.training.ddppo import DDPPOLearner as JaxLearner
from embodied_clip_tpu.training.ppo import PPOConfig as JaxPPOConfig
from embodied_clip_tpu.training.rollout import collect_rollout as jax_collect
from embodied_clip_tpu.zeroshot import goal_map_fn as jax_goal_map_fn
from embodied_clip_tpu.zeroshot import seen_unseen_class_ids as jax_seen_unseen
from embodied_clip_tpu.zeroshot import text_goal_table as jax_text_goal_table

from embodied_clip_tpu_torch import constants
from embodied_clip_tpu_torch.config.rl_experiments import _GoalMappedEnv
from embodied_clip_tpu_torch.envs.gridworld import GridNavEnv
from embodied_clip_tpu_torch.models.convert import from_flax_policy_params
from embodied_clip_tpu_torch.models.policy import ActorCritic
from embodied_clip_tpu_torch.models.tokenizer import SimpleTokenizer
from embodied_clip_tpu_torch.training.evaluate import evaluate_policy
from embodied_clip_tpu_torch.training.rollout import ActState, collect_rollout
from embodied_clip_tpu_torch.zeroshot import (
    DEFAULT_PROMPT,
    goal_map_fn,
    seen_unseen_class_ids,
    text_goal_table,
)

import torch_clip_cases as C
import torch_rl_cases as R

NAMES = constants.ROBOTHOR_OBJECT_TYPES
B, T, HIDDEN = 5, 4, 32


def test_constants_equal_jax():
    from embodied_clip_tpu import constants as jc

    assert constants.ZEROSHOT_SEEN_OBJECTS == jc.ZEROSHOT_SEEN_OBJECTS
    assert constants.ZEROSHOT_UNSEEN_OBJECTS == jc.ZEROSHOT_UNSEEN_OBJECTS


@pytest.mark.parametrize("names", [None, NAMES[::-1], ["Mug", "Apple", "Sofa", "Vase"]])
def test_seen_unseen_class_ids_equal_jax(names):
    assert seen_unseen_class_ids(names) == jax_seen_unseen(names)


@pytest.fixture(scope="module", params=["ViTtiny", "RNtiny"])
def tables(request):
    """(JAX table (numpy), the port's table) of the 12 class names, one CLIP's
    weights."""
    with C.jax_tiny_text_configs():
        built = C.jax_clip(request.param)
        want = jax_text_goal_table(built, JaxTokenizer(), NAMES)
        yield want, text_goal_table(C.port_clip_from_jax(built), SimpleTokenizer(), NAMES)


def test_text_goal_table_matches_jax(tables):
    want, got = tables
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.shape == want.shape == (12, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    torch.testing.assert_close(got.norm(dim=-1), torch.ones(12), atol=1e-6, rtol=0)
    assert DEFAULT_PROMPT == "a photo of a {}."


def test_goal_map_fn_matches_jax(tables):
    want, got = tables
    ids = np.array([3, 0, 11, 3, 7], np.int32)
    np.testing.assert_array_equal(goal_map_fn(got)(torch.from_numpy(ids)).numpy(),
                                  np.asarray(jax_goal_map_fn(got.numpy())(jnp.asarray(ids))))


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


@pytest.fixture(scope="module")
def zeroshot_case(tables):
    """A JAX zero-shot learner as the JAX registry builds it (`rl_experiments.py:
    333,349-351`: the seen class set, `text_embed` goals, the learner's env wrapped
    after construction) and one rollout from its init."""
    table = tables[1].numpy()
    seen = jax_seen_unseen()[0]
    inner = JaxEnv(**R.ENV_KW, class_set=seen)
    jpol = JaxActorCritic(num_actions=6, hidden=HIDDEN, goal_kind="text_embed",
                          goal_input_dim=table.shape[1])
    learner = JaxLearner(inner, jpol, JaxConfig(rollout_len=T, env_batch=B,
                                                ppo=JaxPPOConfig(epochs=1)))
    jenv = JaxGoalMappedEnv(inner, jax_goal_map_fn(table))
    learner.env = jenv
    params, _, act = jax.jit(learner.init)(jax.random.PRNGKey(5))
    out = jax.jit(lambda p, a: jax_collect(jenv, jpol.apply, p, a, T))(params, act)
    return (table, seen, inner, R.tree_np(params), act) + tuple(out)


def test_zeroshot_collect_rollout_matches_jax_replay(zeroshot_case):
    table, seen, inner, params, jact, jr, jlast, jact2, jmetrics = zeroshot_case
    step = R.jax_step_with_fresh(inner)
    js, fresh = jact.env_state, []
    for t in range(T):
        (js, *_), f = step(js, np.asarray(jr.actions[t]))
        fresh.append(f)
    actions = iter(R.t(jr.actions).long())
    pol = ActorCritic(6, R.VISUAL, goal_kind="text_embed", goal_input_dim=table.shape[1],
                      hidden=HIDDEN)
    pol.load_state_dict(from_flax_policy_params(params))
    env = _GoalMappedEnv(ReplayEnv(GridNavEnv(**R.ENV_KW, class_set=seen), fresh),
                         goal_map_fn(torch.from_numpy(table)))
    assert env.num_actions == 6  # the wrapper passes the inner env's attributes through
    act = ActState(env_state=R.to_port_state(jact.env_state),
                   obs={k: R.t(v) for k, v in jact.obs.items()}, h=R.t(jact.h),
                   prev_action=R.t(jact.prev_action).long(), is_start=R.t(jact.is_start))
    roll, last, act2, metrics = collect_rollout(
        env, pol, act, T, torch.Generator(), sample_fn=lambda logits, gen: next(actions))
    want = R.to_port_rollout(jr)
    assert roll.obs["goal"].shape == (T, B, table.shape[1])
    assert set(int(c) for c in np.asarray(jr.obs["visual"]).nonzero()[-1]) <= set(seen) | {12}
    for k in roll.obs:
        assert torch.equal(roll.obs[k], want.obs[k].to(roll.obs[k].dtype)), k
    for f in ("is_start", "actions", "rewards", "dones", "h0"):
        assert torch.equal(getattr(roll, f), getattr(want, f)), f
    for got, ref in ((roll.log_probs, want.log_probs), (roll.values, want.values),
                     (last, R.t(jlast)), (act2.h, R.t(jact2.h))):
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    for f in dataclasses.fields(act2.env_state):
        assert torch.equal(getattr(act2.env_state, f.name), R.t(getattr(jact2.env_state, f.name)))
    torch.testing.assert_close(act2.obs["goal"], R.t(jact2.obs["goal"]), atol=0, rtol=0)
    for k in metrics:
        assert abs(float(metrics[k]) - float(jmetrics[k])) <= 1e-5, k


def test_zeroshot_evaluation_names_every_class(tables):
    """Evaluation on all 12 classes (the unseen included) maps goals through the table
    and records each episode under its class name."""
    table = tables[1]
    env = GridNavEnv(size=5, max_steps=6)
    pol = ActorCritic(6, (7, 7, env.obs_channels), goal_kind="text_embed",
                      goal_input_dim=table.shape[1], hidden=HIDDEN)
    recs = evaluate_policy(env, pol, torch.Generator().manual_seed(0), num_episodes=40,
                           env_batch=8, goal_map_fn=goal_map_fn(table), class_names=NAMES)
    assert len(recs) == 40
    assert {r["task_info"]["object_type"] for r in recs} <= set(NAMES)
