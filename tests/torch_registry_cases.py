"""Shared cases for the registry tests (`test_torch_registry_*.py`): the tiny overrides
of the JAX package's registry smoke test (tests/test_registry_trains.py:29-35), and the
two packages' experiments side by side. Imports no JAX at module level."""

from __future__ import annotations

import dataclasses as dc
import functools

ATOL = 1e-5  # test_torch_policy.py's tolerance

TINY = dict(total_env_steps=64, rollout_len=4, env_batch=8, hidden=32,
            ckpt_every_steps=10_000)


def tiny(exp, **kw):
    """`exp` at test size: hidden 32, rollout 4, 8 envs, and the smoke-scale CLIP trunk
    in f32 where an encoder is registered."""
    over = {**TINY, **kw}
    if exp.encoder is not None and "encoder" not in kw:
        over.setdefault("encoder", "clip_rn_tiny")
        over.setdefault("encoder_dtype", "float32")
    return dc.replace(exp, **over)


def port_experiment(name, **kw):
    from embodied_clip_tpu_torch.config.experiments import get_experiment

    return tiny(get_experiment(name), device="cpu", **kw)


def _jax_obs(jexp_, jenv, pexp_, batch=2):
    """A batch of the JAX env's first observations as the policy reads them: where the
    experiment encodes frames, seeded features of the port encoder's feature shape in
    their place (the encoders are held to each other elsewhere); zero-shot goals as
    fixed unit 1024-d vectors."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    _, obs = jax.jit(jenv.reset, static_argnums=1)(jax.random.PRNGKey(3), batch)
    obs = dict(obs)
    if pexp_._encode_fn() is not None:
        shape = (batch,) + pexp_._encode_fn().feature_shape
        obs["visual"] = jnp.asarray(np.abs(np.random.RandomState(2).randn(*shape))
                                    .astype(np.float32))
    if jexp_.zeroshot:
        g = np.random.RandomState(0).randn(batch, 1024).astype(np.float32)
        obs["goal"] = jnp.asarray(g / np.linalg.norm(g, axis=-1, keepdims=True))
    obs["prev_action"] = jnp.asarray([0, jenv.num_actions][:batch], jnp.int32)
    return obs


@functools.lru_cache(maxsize=None)
def _jitted(module):
    """(jit(module.init), jit(module.apply)), one pair per distinct flax module: the
    registry's names share a handful of policy architectures at test size, so each is
    compiled once."""
    import jax

    return jax.jit(module.init), jax.jit(module.apply)


def check_policy_agrees(name, policy_arch="native"):
    """JAX's `_build_policy(env)` parameters load strictly into the port's, and one
    policy step on the same observations agrees within `ATOL`."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from embodied_clip_tpu.config import experiments as jexp

    from embodied_clip_tpu_torch.config import experiments as pexp
    from embodied_clip_tpu_torch.models.convert import (
        from_flax_allenact_params,
        from_flax_policy_params,
    )

    j = tiny(jexp.get_experiment(name), policy_arch=policy_arch)
    p = tiny(pexp.get_experiment(name), policy_arch=policy_arch, device="cpu")
    jenv, penv = j._build_fake_env(), p._build_fake_env()
    jpol = j._build_policy(jenv)
    obs = _jax_obs(j, jenv, p)
    h0 = jpol.initial_state(2)
    start = jnp.asarray([True, False])
    init, apply = _jitted(jpol)
    params = init(jax.random.PRNGKey(0), obs, h0, start)["params"]
    h0 = jnp.asarray(np.random.RandomState(1).randn(2, 32).astype(np.float32))
    jl, jv, jh = apply({"params": params}, obs, h0, start)

    ppol = p._build_policy(penv)
    params = jax.tree.map(np.asarray, params)
    ppol.load_state_dict(from_flax_allenact_params(params, grid=obs["visual"].shape[1])
                         if policy_arch == "allenact" else from_flax_policy_params(params),
                         strict=True)
    tobs = {k: torch.from_numpy(np.array(v)) for k, v in obs.items()}
    with torch.no_grad():
        pl, pv, ph = ppol(tobs, torch.from_numpy(np.array(h0)),
                          torch.from_numpy(np.array(start)))
    for got, want in ((pl, jl), (pv, jv), (ph, jh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


class SentinelController:
    """A scripted THOR controller (tests/fake_thor.py) that appends each scene it is
    reset to to the file `sentinel`, from inside the pool's worker processes: proof
    that the simulator adapter ran, and on which scenes."""

    def __new__(cls, sentinel, **kw):
        from fake_thor import FakeController

        class _Recording(FakeController):
            def reset(self, scene=None, **kwargs):
                with open(sentinel, "a") as f:
                    f.write(f"{scene}\n")
                return super().reset(scene=scene, **kwargs)

        return _Recording(**kw)


def mp_equiv_rank(workers: int, out_dir: str, run_eval: bool):
    """One process of the multi-process host DD-PPO run (tests/test_multiprocess_ddppo.py's
    worker, in the port): train, optionally evaluate; returns (state_dict as numpy,
    train output, eval output)."""
    from embodied_clip_tpu_torch.config.rl_experiments import NavRLExperiment

    exp = NavRLExperiment(
        name="mp_equiv", task="objectnav", algo="ddppo", encoder=None,
        backend="hostgrid", num_workers=workers, total_env_steps=64, rollout_len=4,
        hidden=16, ppo_epochs=2, seed=7, max_episode_steps=12, eval_episodes=8,
        ckpt_every_steps=10_000, device="cpu")
    out = exp.train(output_dir=out_dir)
    ev = exp.evaluate(output_dir=out_dir) if run_eval else None
    sd = {k: v.numpy().copy() for k, v in exp._last_policy.state_dict().items()}
    return sd, out, ev


def resume_rank(out_dir: str):
    """One process of a 2-process fake-backend run: uninterrupted to 512 env steps, and
    stopped at 256 then resumed; returns both runs' weights (numpy) and the resumed
    run's env steps."""
    from embodied_clip_tpu_torch.config.rl_experiments import NavRLExperiment

    kw = dict(name="mp_resume", backend="fake", encoder=None, total_env_steps=512,
              rollout_len=8, env_batch=16, hidden=16, ckpt_every_steps=256, device="cpu")
    full = NavRLExperiment(**kw)
    full.train(output_dir=f"{out_dir}/full")
    NavRLExperiment(**{**kw, "total_env_steps": 256}).train(output_dir=f"{out_dir}/split")
    resumed = NavRLExperiment(**kw)
    out = resumed.train(output_dir=f"{out_dir}/split")

    def sd(exp):
        return {k: v.numpy().copy() for k, v in exp._last_policy.state_dict().items()}

    return sd(full), sd(resumed), out["env_steps"]


def one_thread():
    """A module fixture's body: torch on one CPU thread while the module runs. These
    tests train tiny models, whose ops are too small to split, beside other test
    processes on the same cores."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
