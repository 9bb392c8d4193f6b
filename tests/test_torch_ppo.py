"""The port's PPO math and optimizer (`embodied_clip_tpu_torch/training/ppo.py`,
`training/optim.py`) against the JAX package's, on the CPU.

Tolerances: `compute_gae` rtol 1e-6 (atol 1e-6 for values near 0); `ppo_loss` and its
metrics on one JAX rollout within 1e-5, its gradients (converted by
`from_flax_policy_params`) within rtol 1e-4 / atol 1e-6; the optimizer fed JAX's
gradients, against `DDPPOLearner.tx` over 3 updates with the LR schedule on, within
1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from embodied_clip_tpu.training.ddppo import DDPPOConfig as JaxConfig
from embodied_clip_tpu.training.ddppo import DDPPOLearner as JaxLearner
from embodied_clip_tpu.training.ppo import PPOConfig as JaxPPOConfig
from embodied_clip_tpu.training.ppo import compute_gae as jax_gae
from embodied_clip_tpu.training.ppo import ppo_loss as jax_loss

from embodied_clip_tpu_torch.models.convert import from_flax_policy_params
from embodied_clip_tpu_torch.training.optim import ClippedAdam
from embodied_clip_tpu_torch.training.ppo import PPOConfig, compute_gae, ppo_loss

import torch_rl_cases as C


@pytest.mark.parametrize("with_valid", [False, True])
def test_gae_matches_jax(with_valid):
    rng = np.random.RandomState(0)
    T, B = 16, 6
    rewards = rng.randn(T, B).astype(np.float32)
    values = rng.randn(T, B).astype(np.float32)
    dones = rng.rand(T, B) < 0.2
    last = rng.randn(B).astype(np.float32)
    valid = C.random_valid(T, B) if with_valid else None
    ja, jr = jax_gae(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(dones),
                     jnp.asarray(last), 0.99, 0.95,
                     valid=None if valid is None else jnp.asarray(valid))
    a, r = compute_gae(*map(torch.from_numpy, (rewards, values, dones, last)), 0.99, 0.95,
                       valid=None if valid is None else torch.from_numpy(valid))
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def case():
    return C.jax_case(batch=4, steps=6)


@pytest.mark.parametrize("with_valid,value_clip", [(False, 0.2), (True, 0.2), (False, 0.0)])
def test_loss_metrics_and_gradients_match_jax(case, with_valid, value_clip):
    jenv, jpol, _, params, _, jr, jlast, _, _ = case
    valid = C.random_valid(6, 4, seed=1) if with_valid else None
    jr = jr._replace(valid=None if valid is None else jnp.asarray(valid))
    cfg = dict(value_clip=value_clip)
    ja, jret = jax_gae(jr.rewards, jr.values, jr.dones, jlast, 0.99, 0.95, valid=jr.valid)
    (jl, jm), jg = jax.jit(lambda p: jax.value_and_grad(jax_loss, has_aux=True)(
        p, jpol.apply, jr, ja, jret, JaxPPOConfig(**cfg)))(jax.tree.map(jnp.asarray, params))

    pol = C.port_policy(params)
    roll = C.to_port_rollout(jr, valid)
    adv, ret = compute_gae(roll.rewards, roll.values, roll.dones, C.t(jlast), 0.99, 0.95,
                           valid=roll.valid)
    loss, metrics = ppo_loss(pol, roll, adv, ret, PPOConfig(**cfg))
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    assert set(metrics) == set(jm)
    for k in jm:
        assert abs(float(metrics[k]) - float(jm[k])) <= 1e-5, k
    want = from_flax_policy_params(C.tree_np(jg))
    for name, p in pol.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_optimizer_matches_optax(case):
    """ClippedAdam against the JAX learner's `tx` (clip_by_global_norm then adam, linear
    LR decay) on the same gradients: a large one (clipped), a small one (not) and a
    third, 3 updates."""
    jenv, jpol, _, params, _, _, _, _, _ = case
    ppo = dict(lr=1e-2, max_grad_norm=0.5, lr_decay_updates=4)
    tx = JaxLearner(jenv, jpol, JaxConfig(ppo=JaxPPOConfig(**ppo))).tx
    rng = np.random.RandomState(2)
    grads = [jax.tree.map(lambda p: (rng.randn(*p.shape) * s).astype(np.float32), params)
             for s in (1.0, 1e-4, 0.05)]
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    pol = C.port_policy(params)
    names = [n for n, _ in pol.named_parameters()]
    opt = ClippedAdam(pol.parameters(), ppo["lr"], ppo["max_grad_norm"],
                      ppo["lr_decay_updates"])
    @jax.jit
    def update(g, state, p):
        upd, state = tx.update(g, state, p)
        return optax.apply_updates(p, upd), state

    for g in grads:
        norm = float(optax.global_norm(g))
        jp, state = update(jax.tree.map(jnp.asarray, g), state, jp)
        gsd = from_flax_policy_params(g)
        opt.step([gsd[n] for n in names])
        want = from_flax_policy_params(C.tree_np(jp))
        for n, p in pol.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=1e-6,
                                       rtol=0, err_msg=f"{n} (grad norm {norm:.3g})")
    assert opt.count == 3
    assert opt.learning_rate() == pytest.approx(1e-2 * (1 - 3 / 4))
