"""The port's allenact policy (`embodied_clip_tpu_torch/models/allenact_policy.py`) on the
CPU.

- It loads the state_dict of `tests/test_allenact_policy.py`'s `_TorchOracle` (allenact
  v0.5.0's ResnetTensorNavActorCritic, with its released key names) with
  `load_state_dict`, and reproduces that oracle over a multi-step sequence with episode
  resets: logits, value and h within atol 1e-5, rtol 1e-4 (the tolerance of
  `tests/test_allenact_policy.py:138-143`), with and without prev-action embeddings;
- `from_flax_allenact_params` carries the JAX module's own params across, and the port
  reproduces the JAX module on the same sequence, at the same tolerance;
- the released key list converts to the released configuration, the `critic.linear`
  fallback loads, a foreign state_dict is refused, `load_allenact_checkpoint` reads a
  saved `.pt`, and `unroll_policy` over the port's module equals its step-by-step
  forward.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_clip_tpu.models.allenact_policy import AllenActResnetPolicy as JaxPolicy

from embodied_clip_tpu_torch.models.allenact_policy import (
    AllenActResnetPolicy,
    allenact_config,
    load_allenact_checkpoint,
)
from embodied_clip_tpu_torch.models.convert import from_flax_allenact_params
from embodied_clip_tpu_torch.models.policy import unroll_policy

from test_allenact_policy import C_IN, G, HID, N_OBJ, _make_oracle

TOL = dict(rtol=1e-4, atol=1e-5)
B, T = 5, 6


def _sequence(seed):
    rng = np.random.RandomState(seed)
    vis = rng.randn(T, B, G, G, C_IN).astype(np.float32)
    goal = rng.randint(0, N_OBJ, (B,))
    actions = rng.randint(0, 6, (T, B))
    dones = np.zeros((T, B), bool)
    dones[0] = True
    dones[3, 1] = dones[4, 3] = True
    return vis, goal, actions, dones


def _port_steps(policy, vis, goal, actions, dones):
    """The port's forward step by step; the prev action is the sentinel 6 at starts."""
    h = policy.initial_state(B)
    prev = np.zeros(B, np.int64)
    outs = []
    for t in range(T):
        obs = {"visual": torch.from_numpy(vis[t]), "goal": torch.from_numpy(goal),
               "prev_action": torch.from_numpy(np.where(dones[t], 6, prev))}
        with torch.no_grad():
            lg, v, h = policy(obs, h, torch.from_numpy(dones[t]))
        outs.append((lg.numpy(), v.numpy(), h.numpy()))
        prev = actions[t]
    return outs


@pytest.mark.parametrize("prev_dims", [0, 8])
def test_loads_oracle_state_dict_and_reproduces_it(prev_dims):
    oracle = _make_oracle(seed=11 if prev_dims else 0, prev_action_dims=prev_dims)
    sd = oracle.state_dict()
    policy = AllenActResnetPolicy(**allenact_config(sd, grid=G))
    policy.load_state_dict(sd)  # allenact's names: no conversion, no permutation
    assert set(policy.state_dict()) == set(sd)
    vis, goal, actions, dones = _sequence(prev_dims)
    got = _port_steps(policy, vis, goal, actions, dones)
    h = torch.zeros(B, HID)
    prev = np.zeros(B, np.int64)
    for t in range(T):
        with torch.no_grad():
            lg, v, h = oracle(torch.from_numpy(vis[t].transpose(0, 3, 1, 2)),
                              torch.from_numpy(goal), h,
                              torch.from_numpy((~dones[t]).astype(np.float32))[:, None],
                              torch.from_numpy(prev))
        for x, y in zip(got[t], (lg.numpy(), v.numpy(), h.numpy())):
            np.testing.assert_allclose(x, y, **TOL)
        prev = actions[t]


@pytest.mark.parametrize("prev_dims", [0, 8])
def test_from_flax_allenact_params_reproduces_jax_module(prev_dims):
    jpol = JaxPolicy(num_goal_classes=N_OBJ, goal_dims=16, compressor_dims=(24, 12),
                     combiner_dims=(20, 10), hidden=HID, prev_action_embed_dims=prev_dims)
    vis, goal, actions, dones = _sequence(7 + prev_dims)
    obs0 = {"visual": jnp.asarray(vis[0]), "goal": jnp.asarray(goal),
            "prev_action": jnp.full((B,), 6, jnp.int32)}
    params = jpol.init(jax.random.PRNGKey(3), obs0, jpol.initial_state(B),
                       jnp.asarray(dones[0]))["params"]
    params = jax.tree.map(lambda p: np.asarray(p) + 0.05 * np.random.RandomState(
        p.size).randn(*p.shape).astype(np.float32), params)  # no zero biases
    sd = from_flax_allenact_params(params, grid=G)
    policy = AllenActResnetPolicy(**allenact_config(sd, grid=G))
    policy.load_state_dict(sd)
    got = _port_steps(policy, vis, goal, actions, dones)
    apply = jax.jit(lambda o, h, d: jpol.apply({"params": params}, o, h, d))
    h = jpol.initial_state(B)
    prev = np.zeros(B, np.int64)
    for t in range(T):
        obs = {"visual": jnp.asarray(vis[t]), "goal": jnp.asarray(goal),
               "prev_action": jnp.asarray(np.where(dones[t], 6, prev).astype(np.int32))}
        lg, v, h = apply(obs, h, jnp.asarray(dones[t]))
        for x, y in zip(got[t], (lg, v, h)):
            np.testing.assert_allclose(x, np.asarray(y), **TOL)
        prev = actions[t]


def test_released_key_list_converts():
    """The released RoboTHOR ObjectNav state_dict's keys and shapes (CLIP RN50 conv map
    2048×7×7, add_prev_actions=False) give the released configuration; a re-exported
    `critic.linear.*` loads as `critic.fc.*`."""
    rng = np.random.RandomState(7)
    shapes = {
        "goal_visual_encoder.embed_goal.weight": (12, 32),
        "goal_visual_encoder.resnet_compressor.0.weight": (128, 2048, 1, 1),
        "goal_visual_encoder.resnet_compressor.0.bias": (128,),
        "goal_visual_encoder.resnet_compressor.2.weight": (32, 128, 1, 1),
        "goal_visual_encoder.resnet_compressor.2.bias": (32,),
        "goal_visual_encoder.target_obs_combiner.0.weight": (128, 64, 1, 1),
        "goal_visual_encoder.target_obs_combiner.0.bias": (128,),
        "goal_visual_encoder.target_obs_combiner.2.weight": (32, 128, 1, 1),
        "goal_visual_encoder.target_obs_combiner.2.bias": (32,),
        "state_encoders.single_belief.rnn.weight_ih_l0": (3 * 512, 32 * 49),
        "state_encoders.single_belief.rnn.weight_hh_l0": (3 * 512, 512),
        "state_encoders.single_belief.rnn.bias_ih_l0": (3 * 512,),
        "state_encoders.single_belief.rnn.bias_hh_l0": (3 * 512,),
        "actor.linear.weight": (6, 512), "actor.linear.bias": (6,),
        "critic.fc.weight": (1, 512), "critic.fc.bias": (1,),
    }
    sd = {k: torch.from_numpy(rng.randn(*s).astype(np.float32) * 0.02)
          for k, s in shapes.items()}
    cfg = allenact_config(sd)
    assert cfg == dict(in_channels=2048, grid=7, num_actions=6, num_goal_classes=12,
                       goal_dims=32, compressor_dims=(128, 32), combiner_dims=(128, 32),
                       hidden=512, prev_action_embed_dims=0)
    policy = AllenActResnetPolicy(**cfg)
    policy.load_state_dict(sd)
    lg, v, h = policy({"visual": torch.zeros(2, 7, 7, 2048), "goal": torch.zeros(2)},
                      policy.initial_state(2), torch.ones(2, dtype=torch.bool))
    assert lg.shape == (2, 6) and v.shape == (2,) and h.shape == (2, 512)
    fallback = dict(sd)
    fallback["critic.linear.weight"] = fallback.pop("critic.fc.weight")
    fallback["critic.linear.bias"] = fallback.pop("critic.fc.bias")
    assert allenact_config(fallback) == cfg


def test_refuses_foreign_state_dict():
    with pytest.raises(ValueError, match="missing keys"):
        allenact_config({"foo.weight": torch.zeros(2, 2)})


def test_load_allenact_checkpoint_and_unroll(tmp_path):
    """A released-layout `.pt` ({"model_state_dict": ..., "total_steps": N}) loads into
    the port's module; `unroll_policy` over it equals its step-by-step forward."""
    oracle = _make_oracle(seed=3)
    path = str(tmp_path / "released.pt")
    torch.save({"model_state_dict": oracle.state_dict(), "total_steps": 130_091_717}, path)
    policy = load_allenact_checkpoint(path, grid=G)
    for k, v in oracle.state_dict().items():
        assert torch.equal(policy.state_dict()[k], v), k
    vis, goal, actions, dones = _sequence(1)
    steps = _port_steps(policy, vis, goal, actions, dones)
    obs = {"visual": torch.from_numpy(vis),
           "goal": torch.from_numpy(np.broadcast_to(goal, (T, B)).copy())}
    with torch.no_grad():
        lg, v, h = unroll_policy(policy, obs, policy.initial_state(B), torch.from_numpy(dones))
    np.testing.assert_allclose(lg.numpy(), np.stack([s[0] for s in steps]), **TOL)
    np.testing.assert_allclose(v.numpy(), np.stack([s[1] for s in steps]), **TOL)
    np.testing.assert_allclose(h.numpy(), steps[-1][2], **TOL)
