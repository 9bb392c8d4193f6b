"""Shared cases for the DD-PPO parity tests (`test_torch_ppo.py`, `test_torch_ddppo.py`):
a JAX rollout at test size, its conversion into the port's types, and the rank function
the multi-process tests run. JAX is imported only inside the functions that build JAX
objects, so the spawned gloo workers import torch and the port alone.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from embodied_clip_tpu_torch.envs.gridworld import GridNavEnv, GridNavState
from embodied_clip_tpu_torch.models.convert import from_flax_policy_params
from embodied_clip_tpu_torch.models.policy import ActorCritic
from embodied_clip_tpu_torch.training.ppo import Rollout

HIDDEN = 32
VISUAL = (7, 7, 13)  # the map policy's input: the env's egocentric class map
ENV_KW = {"size": 5, "max_steps": 3}  # episodes end inside a short rollout


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def tree_np(tree):
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    return np.array(tree)


def port_policy(params=None, seed: int = 0) -> ActorCritic:
    pol = ActorCritic(6, VISUAL, hidden=HIDDEN, num_goal_classes=12, seed=seed)
    if params is not None:
        pol.load_state_dict(from_flax_policy_params(params))
    return pol


def to_port_state(js) -> GridNavState:
    return GridNavState(**{f.name: t(getattr(js, f.name))
                           for f in dataclasses.fields(GridNavState)})


def to_port_rollout(jr, valid=None) -> Rollout:
    return Rollout(obs={k: t(v) for k, v in jr.obs.items()}, is_start=t(jr.is_start),
                   actions=t(jr.actions).long(), log_probs=t(jr.log_probs),
                   values=t(jr.values), rewards=t(jr.rewards), dones=t(jr.dones),
                   h0=t(jr.h0), valid=None if valid is None else torch.from_numpy(valid))


def jax_case(batch: int, steps: int, seed: int = 0):
    """A JAX learner (map policy, hidden 32) and one rollout of `steps` × `batch` from
    its own init: (jenv, jpolicy, jlearner, params (numpy), act before, rollout,
    last_value, act after, env metrics)."""
    import jax

    from embodied_clip_tpu.envs.gridworld import GridNavEnv as JaxEnv
    from embodied_clip_tpu.models.policy import ActorCritic as JaxActorCritic
    from embodied_clip_tpu.training.ddppo import DDPPOConfig as JaxConfig
    from embodied_clip_tpu.training.ddppo import DDPPOLearner as JaxLearner
    from embodied_clip_tpu.training.ppo import PPOConfig as JaxPPOConfig
    from embodied_clip_tpu.training.rollout import collect_rollout

    jenv = JaxEnv(**ENV_KW)
    jpol = JaxActorCritic(num_actions=6, hidden=HIDDEN, num_goal_classes=12)
    learner = JaxLearner(jenv, jpol, JaxConfig(rollout_len=steps, env_batch=batch,
                                               ppo=JaxPPOConfig(epochs=1)))
    params, _, act = jax.jit(learner.init)(jax.random.PRNGKey(seed))
    out = jax.jit(lambda p, a: collect_rollout(jenv, jpol.apply, p, a, steps))(params, act)
    return (jenv, jpol, learner, tree_np(params), act) + tuple(out)


def jax_step_with_fresh(env):
    """A jitted fn (state, action) → (JAX's `step` outputs, the fresh episodes that step
    draws from the stepped state's keys, as a port state)."""
    import jax
    import jax.numpy as jnp

    def fn(js, action):
        nxt = jax.vmap(lambda k: jax.random.split(k, 2))(js.key)
        return env.step(js, action), jax.vmap(env._init_episode)(nxt[:, 0])

    jfn = jax.jit(fn)

    def call(js, action):
        out, (pos, dirs, opos, ocls, tidx, start) = jfn(js, jnp.asarray(action))
        zeros = torch.zeros(action.shape[0], dtype=torch.int32)
        fresh = GridNavState(agent_pos=t(pos), agent_dir=t(dirs), agent_hor=zeros,
                             object_pos=t(opos), object_cls=t(ocls),
                             target_idx=t(tidx), t=zeros.clone(), start_dist=t(start))
        return out, fresh

    return call


def random_valid(steps: int, batch: int, seed: int = 0) -> np.ndarray:
    """A straggler mask: about a fifth of the steps fabricated."""
    return np.random.RandomState(seed).rand(steps, batch) > 0.2


def update_rank(params_sd, rollout: Rollout, last_value, cfg):
    """One rank of a data-parallel update: this rank's env slice of the global rollout,
    then `DDPPOLearner.update`. Returns (state_dict after, metrics) as numpy."""
    from embodied_clip_tpu_torch.parallel import mesh
    from embodied_clip_tpu_torch.training.ddppo import DDPPOLearner

    pol = port_policy()
    pol.load_state_dict(params_sd)
    learner = DDPPOLearner(GridNavEnv(**ENV_KW), pol, cfg, device="cpu")
    own = mesh.shard_batch(cfg.env_batch)
    metrics = learner.update(rollout.envs(own), last_value[own])
    return ({k: v.numpy().copy() for k, v in pol.state_dict().items()},
            {k: float(v) for k, v in metrics.items()})


def record_steps(tx) -> list:
    """Keep the gradients of every `tx.step` from now on: returns the list that each step
    appends its gradients to (in the order of the optimizer's parameters)."""
    steps, step = [], tx.step

    def recording(grads=None):
        steps.append([g.detach().clone() for g in grads])
        return step(grads)

    tx.step = recording
    return steps


def min_abs_grads(policy, steps) -> dict:
    """Each parameter's smallest |gradient| over the recorded steps, by name."""
    names = [n for n, _ in policy.named_parameters()]
    return {n: torch.stack([s[i].abs() for s in steps]).amin(0).cpu()
            for i, n in enumerate(names)}


def assert_adam_close(got: dict, want: dict, min_abs_grad: dict, lr: float, steps: int):
    """Weights after `steps` Adam steps within 1e-6 of `want` wherever every step's
    gradient is at least 1e-6. Below that, Adam's step g / (sqrt(v) + 1e-8) is set by
    float32 summation noise (two computations sum in different orders), and a weight may
    move by up to lr either way a step: within 2·lr·steps."""
    for name, w in want.items():
        d = (torch.as_tensor(got[name]) - torch.as_tensor(w)).abs()
        tiny = min_abs_grad[name] < 1e-6
        assert float(torch.where(tiny, 0.0, d).max()) <= 1e-6, name
        assert float(torch.where(tiny, d, 0.0).max()) <= 2 * lr * steps, name
