"""Policy evaluation: per-episode success/SPL records and the metrics.json writer (port
of `embodied_clip_tpu/training/evaluate.py`).

The reference's RL eval contract (readme_files/zeroshot_objectnav.md:34-47): eval
writes per-episode records `{"success", "spl", "ep_length", "task_info": {"object_type":
…}}` under `[{"tasks": [...]}]`, and `compute_scores` averages success/SPL per object
type as the readme's snippet does.

`evaluate_policy` runs an on-device env in chunks of 128 steps and gathers finished
episodes on the host until the requested count is reached; `evaluate_policy_host` runs a
`VectorEnv` of simulator workers.
"""

from __future__ import annotations

import json
import warnings
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from embodied_clip_tpu_torch.training.host_rollout import keyed_sample
from embodied_clip_tpu_torch.training.rollout import policy_obs, sample_actions

__all__ = ["evaluate_policy", "evaluate_policy_host", "write_metrics_json",
           "compute_scores"]

_CHUNK = 128


def _record(success, spl, ep_len, cls, class_names) -> Dict:
    return {"success": float(success), "spl": float(spl), "ep_length": float(ep_len),
            "task_info": {"object_type": class_names[cls] if class_names else str(cls)}}


@torch.no_grad()
def evaluate_policy(env, policy, generator: torch.Generator, num_episodes: int,
                    env_batch: int = 32, max_steps_total: Optional[int] = None,
                    deterministic: bool = True, encode_fn: Optional[Callable] = None,
                    goal_map_fn: Optional[Callable] = None,
                    class_names: Optional[Sequence[str]] = None) -> List[Dict]:
    """Run `env_batch` envs of `env` (on `generator`'s device) until `num_episodes`
    episodes finish; returns their records in finishing order.

    `max_steps_total=None` sizes the step budget from the request: every requested
    episode may run a full horizon, with 4× slack. If the budget runs out first, a
    warning reports the shortfall and the result is shorter."""
    dev = generator.device
    if max_steps_total is None:
        per_batch = -(-num_episodes // max(env_batch, 1))  # episodes each slot owes
        max_steps_total = max(4096, 4 * per_batch * int(getattr(env, "max_steps", 512)))
    state, obs = env.reset(generator, env_batch)
    h = policy.initial_state(env_batch, dev)
    prev_a = torch.full((env_batch,), env.num_actions, dtype=torch.long, device=dev)
    start = torch.ones(env_batch, dtype=torch.bool, device=dev)
    episodes: List[Dict] = []
    steps = 0
    while len(episodes) < num_episodes and steps < max_steps_total:
        recs = {k: [] for k in ("done", "success", "spl", "episode_len", "goal")}
        for _ in range(_CHUNK):
            recs["goal"].append(obs["goal"])
            logits, _, h = policy(policy_obs(obs, prev_a, encode_fn, goal_map_fn), h, start)
            action = (logits.argmax(-1) if deterministic
                      else sample_actions(logits, generator))
            state, obs, _, done, info = env.step(state, action, generator)
            prev_a = torch.where(done, env.num_actions, action)
            start = done
            recs["done"].append(done)
            for k in ("success", "spl", "episode_len"):
                recs[k].append(info[k])
        steps += _CHUNK
        done, success, spl, ep_len, goal = (torch.stack(recs[k]).cpu().numpy() for k in
                                            ("done", "success", "spl", "episode_len", "goal"))
        for t in range(done.shape[0]):
            for b in np.nonzero(done[t])[0]:
                episodes.append(_record(success[t, b], spl[t, b], ep_len[t, b],
                                        int(goal[t, b]), class_names))
    if len(episodes) < num_episodes:
        warnings.warn(f"evaluate_policy delivered {len(episodes)}/{num_episodes} episodes "
                      f"before exhausting max_steps_total={max_steps_total}; metrics "
                      "aggregates cover only the completed episodes", RuntimeWarning,
                      stacklevel=2)
    return episodes[:num_episodes]


@torch.no_grad()
def evaluate_policy_host(venv, policy, num_episodes: int, num_actions: int,
                         deterministic: bool = True, encode_fn: Optional[Callable] = None,
                         goal_map_fn: Optional[Callable] = None,
                         class_names: Optional[Sequence[str]] = None,
                         max_steps_total: Optional[int] = None, seed: int = 0,
                         device="cuda") -> List[Dict]:
    """Evaluate on a host simulator pool, the reference's checkpoint-eval contract (eval
    on the simulator's val scenes, baselines_robothor_objectnav.md:54-68,
    baselines_habitat.md:88-97): greedy (or keyed-sampled, from `seed`) actions over a
    VectorEnv of THOR/Habitat workers, with the frozen encode and the policy step on
    `device`; records in the schema of `evaluate_policy`. Straggler-masked transitions
    record no episode.

    The default step budget gives every requested episode the pool's horizon
    (`venv.max_steps`, or 512 where the pool does not know it) with 4× slack."""
    obs = venv.reset()
    b = next(iter(obs.values())).shape[0]
    h = policy.initial_state(b, device)
    prev_a = torch.full((b,), num_actions, dtype=torch.long, device=device)
    is_start = torch.ones(b, dtype=torch.bool, device=device)
    env_ids = torch.arange(b, device=device)
    if max_steps_total is None:
        horizon = getattr(venv, "max_steps", None) or 512
        max_steps_total = max(4096, 4 * -(-num_episodes // max(b, 1)) * int(horizon))
    episodes: List[Dict] = []
    steps = 0
    while len(episodes) < num_episodes and steps < max_steps_total:
        goal_now = np.asarray(obs["goal"])
        o = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in obs.items()}
        logits, _, h = policy(policy_obs(o, prev_a, encode_fn, goal_map_fn), h, is_start)
        action = (logits.argmax(-1) if deterministic
                  else keyed_sample(logits, seed, steps, env_ids))
        obs, _rew, done, infos, valid = venv.step(action.cpu().numpy())
        done = np.asarray(done, bool)
        steps += 1
        for i in range(b):
            if not (done[i] and valid[i]) or "success" not in infos[i]:
                continue
            inf = infos[i]
            cls = inf.get("object_type")
            if cls is None:
                g = int(goal_now[i]) if np.ndim(goal_now[i]) == 0 else -1
                cls = (class_names[g] if class_names and 0 <= g < len(class_names)
                       else str(g))
            episodes.append({"success": float(inf["success"]),
                             "spl": float(inf.get("spl", 0.0)),
                             "ep_length": float(inf.get("episode_len", 0.0)),
                             "task_info": {"object_type": str(cls)}})
            if len(episodes) >= num_episodes:
                break
        is_start = torch.from_numpy(done).to(device)
        prev_a = torch.where(is_start, num_actions, action)
    if len(episodes) < num_episodes:
        warnings.warn(f"evaluate_policy_host delivered {len(episodes)}/{num_episodes} "
                      f"episodes before exhausting max_steps_total={max_steps_total}",
                      RuntimeWarning, stacklevel=2)
    return episodes[:num_episodes]


def write_metrics_json(path: str, episodes: List[Dict]) -> str:
    """The reference's schema: a list whose first element holds {"tasks": [...]}
    (zeroshot_objectnav.md:38-40 reads metrics[0]['tasks'])."""
    with open(path, "w") as f:
        json.dump([{"tasks": episodes}], f)
    return path


def compute_scores(metrics_file: str, obj_type: str):
    """Average success/SPL for one object type (the readme's compute_scores snippet,
    zeroshot_objectnav.md:36-47)."""
    with open(metrics_file) as f:
        metrics = json.load(f)
    episodes = [ep for ep in metrics[0]["tasks"]
                if ep["task_info"]["object_type"] == obj_type]
    if not episodes:
        return 0.0, 0.0
    success = sum(ep["success"] for ep in episodes) / len(episodes)
    spl = sum(ep["spl"] for ep in episodes) / len(episodes)
    return success, spl
