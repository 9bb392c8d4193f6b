"""The port's GridNavEnv (`embodied_clip_tpu_torch/envs/gridworld.py`) against the JAX
package's, on the CPU.

JAX's states come from its own `reset` and `step`; `jax.random` cannot be reproduced in
torch, so the port is given JAX's states, actions and fresh episodes. Tolerances:
observations, frames, states, rewards, dones and infos bit-equal; `expert_action`
equal; the pointnav goal and the depth map within 1e-6 (atan2 / norm ulps). torch's own
draws are held to their distributions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from embodied_clip_tpu.envs.gridworld import GridNavEnv as JaxEnv

from embodied_clip_tpu_torch.envs.gridworld import GridNavEnv, GridNavState

from torch_rl_cases import jax_step_with_fresh

FIELDS = [f.name for f in dataclasses.fields(GridNavState)]
CONFIGS = {
    "objectnav": {},
    "pointnav": {"task": "pointnav"},
    "frames": {"frame_obs": True, "frame_cell_px": 4},
    "flat": {"flat_obs": True},
    "depth": {"depth_obs": True},
    "frames_depth": {"frame_obs": True, "depth_obs": True, "frame_cell_px": 2},
    "class_set": {"class_set": (1, 4, 7), "num_objects": 3},
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def to_torch_state(js) -> GridNavState:
    return GridNavState(**{f: _t(getattr(js, f)) for f in FIELDS})


def assert_obs_equal(got, want, task):
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.shape == w.shape, k
        if k == "depth" or (k == "goal" and task == "pointnav"):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0, err_msg=k)
        else:
            assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=k)


def assert_state_equal(got: GridNavState, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_steps_match_jax(name):
    """Reset then 12 steps of random actions (every action, episodes that end by End and
    by timeout): `advance` + `auto_reset` with JAX's fresh episodes equal JAX's `step`,
    and the observations of every state equal JAX's."""
    kw = dict(size=5, max_steps=6, **CONFIGS[name])
    jenv, env = JaxEnv(**kw), GridNavEnv(**kw)
    b = 8
    js, jobs = jax.jit(jenv.reset, static_argnums=1)(jax.random.PRNGKey(3), b)
    assert_obs_equal(env.observe(to_torch_state(js)), jobs, env.task)
    jstep = jax_step_with_fresh(jenv)
    rng = np.random.RandomState(0)
    for t in range(12):
        action = rng.randint(0, 6, b).astype(np.int32)
        state = to_torch_state(js)
        (js, jobs, jrew, jdone, jinfo), fresh = jstep(js, action)
        stepped, reward, done, info = env.advance(state, torch.from_numpy(action).long())
        new = env.auto_reset(stepped, done, fresh)
        assert_state_equal(new, js)
        np.testing.assert_array_equal(reward.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
        assert set(info) == set(jinfo)
        for k in info:
            np.testing.assert_array_equal(info[k].numpy(), np.asarray(jinfo[k]), err_msg=k)
        assert_obs_equal(env.observe(new), jobs, env.task)


def test_frames_bit_equal_where_objects_share_a_cell():
    """Two objects in one cell sum two hues before the uint8 truncation: the port carries
    JAX's float32 hue table, so the frames stay bit-equal."""
    kw = dict(size=5, num_objects=3)
    jenv, env = JaxEnv(**kw), GridNavEnv(**kw)
    js, _ = jax.jit(jenv.reset, static_argnums=1)(jax.random.PRNGKey(5), 16)
    pos = np.asarray(js.object_pos).copy()
    pos[:, 1] = pos[:, 0]  # objects 0 and 1 share a cell
    cls = np.tile(np.arange(12, dtype=np.int32)[None], (16, 1))
    cls = np.stack([np.roll(cls, -i, 1)[i, :3] for i in range(16)])
    js = js.replace(object_pos=jnp.asarray(pos), object_cls=jnp.asarray(cls))
    state = to_torch_state(js)
    for px in (8, 3):
        want = np.asarray(jax.jit(jenv.render_frames, static_argnums=1)(js, px))
        got = env.render_frames(state, cell_px=px)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
    # torch.linspace's table would differ from JAX's here.
    assert not torch.equal(torch.linspace(0.1, 1.0, 12),
                           _t(jnp.linspace(0.1, 1.0, 12)))


@pytest.mark.parametrize("task", ["objectnav", "pointnav"])
def test_expert_action_matches_jax(task):
    jenv, env = JaxEnv(size=6, task=task), GridNavEnv(size=6, task=task)
    js, _ = jax.jit(jenv.reset, static_argnums=1)(jax.random.PRNGKey(7), 64)
    hor = np.random.RandomState(1).randint(-1, 2, 64).astype(np.int32)
    js = js.replace(agent_hor=jnp.asarray(hor))
    got = env.expert_action(to_torch_state(js))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.jit(jenv.expert_action)(js)))


@pytest.mark.parametrize("kw", [{}, {"class_set": (2, 5, 9)}, {"num_objects": 4, "size": 3}])
def test_torch_draws_follow_the_episode_distribution(kw):
    """torch's draws cannot equal jax.random's: hold them to the distribution JAX's
    `_init_episode` draws from, and to the generator alone."""
    env = GridNavEnv(**kw)
    b = 512
    s, obs = env.reset(torch.Generator().manual_seed(0), b)
    pool = set(kw.get("class_set", range(env.num_classes)))
    assert all(x.dtype == torch.int32 for x in (s.agent_pos, s.object_cls, s.target_idx))
    assert int(s.agent_pos.min()) >= 0 and int(s.agent_pos.max()) < env.size
    assert int(s.object_pos.min()) >= 0 and int(s.object_pos.max()) < env.size
    assert set(s.agent_dir.unique().tolist()) == {0, 1, 2, 3}
    assert set(s.object_cls.unique().tolist()) == pool
    for row in s.object_cls.tolist():  # distinct classes per episode
        assert len(set(row)) == min(env.num_objects, len(pool))
    assert set(s.target_idx.unique().tolist()) == set(range(env.num_objects))
    tgt = s.object_pos[torch.arange(b), s.target_idx.long()]
    dist = (s.agent_pos - tgt).abs().sum(-1)
    assert torch.equal(s.start_dist, dist.clamp_min(1).int()) and int(s.start_dist.min()) >= 1
    assert int(s.t.abs().sum()) == 0 and int(s.agent_hor.abs().sum()) == 0
    assert torch.equal(obs["goal"], s.object_cls.gather(1, s.target_idx.long()[:, None])[:, 0])
    again, _ = env.reset(torch.Generator().manual_seed(0), b)
    assert all(torch.equal(getattr(s, f), getattr(again, f)) for f in FIELDS)


def test_step_draws_fresh_episodes_where_done():
    env = GridNavEnv(size=5, max_steps=3)
    gen = torch.Generator().manual_seed(1)
    s, _ = env.reset(gen, 6)
    action = torch.tensor([5, 5, 5, 0, 1, 2])  # End ends an episode at once
    s2, obs, reward, done, info = env.step(s, action, gen)
    assert done.tolist() == [True] * 3 + [False] * 3
    assert s2.t.tolist() == [0, 0, 0, 1, 1, 1]
    assert torch.equal(info["done"], done.float())
    assert obs["visual"].shape == (6, 7, 7, env.obs_channels)
