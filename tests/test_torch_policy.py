"""The port's ActorCritic (`embodied_clip_tpu_torch/models/policy.py`) against the JAX
package's, on the CPU.

JAX's params go into the port through `from_flax_policy_params`; the same numpy inputs
(made from a seed) go through one policy step with episode resets and through
`unroll_policy`. Tolerance: logits, values and hidden states within atol 1e-5. Covered:
the conv-map compressor (with and without an RGBD depth channel), the flat
`visual_is_map=False` path, ScratchCNN on uint8 frames and RGBD (odd sizes: flax's
asymmetric SAME padding), and all four goal kinds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_clip_tpu.models.policy import ActorCritic as JaxActorCritic
from embodied_clip_tpu.models.policy import unroll_policy as jax_unroll

from embodied_clip_tpu_torch.models.convert import from_flax_policy_params
from embodied_clip_tpu_torch.models.policy import ActorCritic, unroll_policy

ATOL = 1e-5
A = 6
# name: (policy kwargs, {obs key: (per-sample shape, kind)})
CASES = {
    "map_object": ({"goal_kind": "object_embed"},
                   {"visual": ((7, 7, 13), "float"), "goal": ((), "class")}),
    "map_rgbd_text": ({"goal_kind": "text_embed", "goal_input_dim": 16, "depth": True},
                      {"visual": ((4, 4, 24), "float"), "depth": ((20, 20, 1), "unit"),
                       "goal": ((16,), "float")}),
    "flat_pointgoal": ({"goal_kind": "pointgoal", "goal_input_dim": 2,
                        "visual_is_map": False},
                       {"visual": ((637,), "float"), "goal": ((2,), "float")}),
    "scratch_none": ({"goal_kind": "none", "scratch_cnn": True},
                     {"visual": ((28, 28, 3), "uint8")}),
    "scratch_rgbd_object_noprev": ({"goal_kind": "object_embed", "scratch_cnn": True,
                                    "depth": True, "use_prev_action": False},
                                   {"visual": ((30, 30, 3), "uint8"),
                                    "depth": ((30, 30, 1), "unit"),
                                    "goal": ((), "class")}),
}


def make_obs(spec, lead, rng):
    obs = {}
    for k, (shape, kind) in spec.items():
        full = lead + shape
        if kind == "class":
            obs[k] = rng.randint(0, 12, full).astype(np.int32)
        elif kind == "uint8":
            obs[k] = rng.randint(0, 256, full).astype(np.uint8)
        elif kind == "unit":
            obs[k] = rng.rand(*full).astype(np.float32)
        else:
            obs[k] = rng.randn(*full).astype(np.float32)
    obs["prev_action"] = rng.randint(0, A + 1, lead).astype(np.int32)
    return obs


def build(name, hidden=32):
    kw, spec = CASES[name]
    rng = np.random.RandomState(0)
    jkw = {k: v for k, v in kw.items() if k != "depth"}
    jpol = JaxActorCritic(num_actions=A, hidden=hidden, **jkw)
    obs0 = make_obs(spec, (2,), rng)
    params = jax.jit(jpol.init)(jax.random.PRNGKey(1), jax.tree.map(jnp.asarray, obs0),
                                jpol.initial_state(2), jnp.zeros((2,), bool))["params"]
    params = jax.tree.map(np.asarray, params)
    pol = ActorCritic(A, spec["visual"][0], hidden=hidden, **kw)
    pol.load_state_dict(from_flax_policy_params(params))
    return jpol, params, pol, spec, rng


def tt(obs):
    return {k: torch.from_numpy(np.array(v)) for k, v in obs.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_step_and_unroll_match_jax(name):
    jpol, params, pol, spec, rng = build(name)
    b, t = 5, 6
    obs = make_obs(spec, (b,), rng)
    h = rng.randn(b, 32).astype(np.float32)
    done = np.array([True, False, True, False, False])
    jl, jv, jh = jax.jit(jpol.apply)({"params": params}, jax.tree.map(jnp.asarray, obs),
                                     jnp.asarray(h), jnp.asarray(done))
    with torch.no_grad():
        logits, value, h1 = pol(tt(obs), torch.from_numpy(h), torch.from_numpy(done))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(value.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
    np.testing.assert_allclose(h1.numpy(), np.asarray(jh), atol=ATOL, rtol=0)

    seq = make_obs(spec, (t, b), rng)
    dones = rng.rand(t, b) < 0.3
    jl, jv, jh = jax.jit(lambda *a: jax_unroll(jpol.apply, *a))(
        params, jax.tree.map(jnp.asarray, seq), jnp.asarray(h), jnp.asarray(dones))
    with torch.no_grad():
        logits, values, ht = unroll_policy(pol, tt(seq), torch.from_numpy(h),
                                           torch.from_numpy(dones))
    assert logits.shape == (t, b, A) and values.shape == (t, b) and ht.shape == (b, 32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    np.testing.assert_allclose(values.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ht.numpy(), np.asarray(jh), atol=ATOL, rtol=0)


def test_port_init_has_flax_shapes_and_scales():
    """The port's own init has flax's parameter set (the converter round-trips every
    entry) and its scales: LeCun kernels, zero biases, orthogonal recurrent gates."""
    jpol, params, _, spec, _ = build("map_object", hidden=64)
    pol = ActorCritic(A, spec["visual"][0], hidden=64, seed=3)
    ref = from_flax_policy_params(params)
    sd = pol.state_dict()
    assert set(sd) == set(ref)
    assert all(sd[k].shape == ref[k].shape for k in sd)
    for k in ("compressor.reduce.weight", "gru.weight_ih", "actor.weight"):
        assert abs(float(sd[k].std()) / float(ref[k].std()) - 1) < 0.1, k
    for gate in range(3):
        w = sd["gru.weight_hh"][gate * 64:(gate + 1) * 64]
        torch.testing.assert_close(w @ w.T, torch.eye(64), atol=1e-5, rtol=0)
    assert float(sd["gru.bias_hh"].abs().sum()) == 0
    again = ActorCritic(A, spec["visual"][0], hidden=64, seed=3).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_recurrent_r_z_biases_stay_zero():
    """flax's hr/hz carry no bias: their rows of gru.bias_hh get no gradient."""
    _, _, pol, spec, rng = build("map_object")
    obs = tt(make_obs(spec, (3,), rng))
    h0 = torch.from_numpy(rng.randn(3, 32).astype(np.float32))
    logits, value, h = pol(obs, h0, torch.zeros(3, dtype=torch.bool))
    (logits.sum() + value.sum() + h.sum()).backward()
    g = pol.gru.bias_hh.grad
    assert float(g[:64].abs().sum()) == 0 and float(g[64:].abs().sum()) > 0
