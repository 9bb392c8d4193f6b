"""Host-env rollout collection: CPU simulators feeding the policy on the card (port of
`embodied_clip_tpu/training/host_rollout.py`).

A `VectorEnv` pool steps AI2-THOR/Habitat-style `HostEnv`s while the device runs one act
step a step: the frozen encoder on the uint8 frame batch, then the policy step.
Actions go to the pool asynchronously, so the simulators step while the host records
the step. The result is the same `Rollout` as the on-device path's, so the PPO and DAgger
learners do not care where a rollout came from.

Pipelining: given a LIST of pools, the collector software-pipelines them: while group
g's simulators compute step t+1, the device runs the act step of group g+1. Each group
is a disjoint set of envs, so the (T, B) rollout is exactly what one pool of the same
envs would give. With one pool the schedule is the sequential act → step loop.

Frames cross from the pool to the card as one uint8 batch a group a step. The pool has
already copied them out of its shared-memory ring into a private numpy batch (the
seqlock read), so no worker can overwrite what is being copied; the copy to the card is
an ordinary synchronous one (2.2 MB for 8 THOR frames).

Sampling is keyed: the action of env i at its group's step t is a function of (seed,
t, global env id i) alone (`keyed_sample`, Gumbel-max over a counter-based hash), so N
processes × B/N envs, or G pipeline groups, collect what one pool of B envs collects.
`sample_fn` is swappable (tests replay the JAX package's actions through it).

DD-PPO's straggler cutoff lives in `VectorEnv` (`cutoff_fraction`): a masked step is
recorded as done False, reward 0, with the repeated observation, and flagged in
`Rollout.valid`; GAE passes through it and the PPO loss gives it no gradient.

The encoder's features are inference tensors; they are copied into the rollout's
ordinary storage, allocated on the device at the first step, so that the update can
save them for backward.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from embodied_clip_tpu_torch.models.encoders import _device
from embodied_clip_tpu_torch.training.ppo import Rollout
from embodied_clip_tpu_torch.training.rollout import policy_obs
from embodied_clip_tpu_torch.utils.profiling import StageTimer

__all__ = ["HostRolloutCollector", "keyed_uniform", "keyed_sample"]

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x · c mod 2³² for int64 x in [0, 2³²), with no intermediate above 2⁴⁹."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finaliser (lowbias32) on int64 tensors holding 32-bit words."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def keyed_uniform(seed: int, t: int, env_ids: torch.Tensor, n: int) -> torch.Tensor:
    """(len(env_ids), n) float64 uniforms in (0, 1), each a hash of (seed, t, env id,
    column): the same numbers for an env whatever batch it sits in, on any device."""
    h = torch.full((), 0x9E3779B9, dtype=torch.int64, device=env_ids.device)
    cols = torch.arange(n, dtype=torch.int64, device=env_ids.device)
    for word in (seed & _M32, (seed >> 32) & _M32, env_ids.long()[:, None] & _M32, cols,
                 t & _M32):
        h = _mix32(h ^ word)
    return (h.double() + 0.5) / 2.0 ** 32


def keyed_sample(logits: torch.Tensor, seed: int, t: int, env_ids: torch.Tensor
                 ) -> torch.Tensor:
    """Categorical samples of (B, A) logits by Gumbel-max over `keyed_uniform`, (B,)
    int64: env i's action at step t depends on (seed, t, env id, its logits) only."""
    u = keyed_uniform(seed, t, env_ids, logits.shape[-1])
    return (logits.double() - torch.log(-torch.log(u))).argmax(-1)


class HostRolloutCollector:
    def __init__(self, venv, policy, encode_fn: Optional[Callable] = None,
                 goal_map_fn: Optional[Callable] = None, env_id_offset: int = 0,
                 device="cuda", sample_fn: Callable = keyed_sample):
        """`venv`: one VectorEnv or a list of pools (pipelined groups). `env_id_offset`:
        this process's first GLOBAL env index (process p of a multi-process DD-PPO run
        passes p·B_local). `sample_fn(logits, seed, t, global env ids)` draws actions."""
        self.venvs = list(venv) if isinstance(venv, (list, tuple)) else [venv]
        self.venv = self.venvs[0]
        self.policy = policy
        self.encode_fn = encode_fn
        self.goal_map_fn = goal_map_fn
        self.sample_fn = sample_fn
        self.device = _device(device)
        starts = np.cumsum([0] + [v.n for v in self.venvs])
        # Each group's columns in the batch (group order) and its global env ids.
        self._cols = [slice(int(a), int(b)) for a, b in zip(starts[:-1], starts[1:])]
        self._env_ids = [torch.arange(env_id_offset + a, env_id_offset + b,
                                      device=self.device) for a, b in zip(starts[:-1],
                                                                          starts[1:])]
        self._g: Optional[List[Dict]] = None  # per-group live state
        self.seed = 0
        # Per-stage wall time: "act" = the device act step with the frozen encode,
        # "env_step" = waiting on the pool. The learner adds "update". With pipelined
        # groups the stage sums overlap in wall time.
        self.timer = StageTimer()

    # ------------------------------------------------------------------ state views

    @property
    def num_envs(self) -> int:
        return sum(v.n for v in self.venvs)

    @property
    def venv_num_actions(self) -> int:
        return getattr(self.venv, "num_actions", None) or self.policy.num_actions

    @property
    def _obs(self) -> Dict[str, np.ndarray]:
        gs = self._g
        return {k: np.concatenate([g["obs"][k] for g in gs]) for k in gs[0]["obs"]}

    @property
    def _h(self) -> torch.Tensor:
        return torch.cat([g["h"] for g in self._g])

    def _policy_obs(self, obs_np: Dict[str, np.ndarray], prev_action: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        """A group's numpy observations → the policy's inputs on the device: frames
        through the frozen encoder; a 1-phase rearrangement's goal view through it too,
        channel-concatenated after the current view's features."""
        o = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
             for k, v in obs_np.items()}
        goal_view = o.pop("goal_visual", None)
        o = policy_obs(o, prev_action, self.encode_fn, self.goal_map_fn)
        if goal_view is not None:
            if self.encode_fn is not None:
                goal_view = self.encode_fn(goal_view)
            o["visual"] = torch.cat([o["visual"], goal_view], -1)
        return o

    def reset(self, seed: int = 0) -> None:
        """Reset every pool; `seed` keys the action samples."""
        self._g = []
        for venv in self.venvs:
            n = venv.n
            self._g.append({
                "obs": venv.reset(),
                "h": torch.zeros(n, self.policy.hidden, device=self.device),
                "prev_action": torch.full((n,), self.venv_num_actions, dtype=torch.long,
                                          device=self.device),
                "is_start": torch.ones(n, dtype=torch.bool, device=self.device),
                # step count (the sampler's t); DAgger's taint carried across calls
                "t": 0, "valid_prev": np.ones(n, bool),
            })
        self.seed = int(seed)

    # ----------------------------------------------------------------- collection

    def _store(self, buf: Dict[str, torch.Tensor], t: int, cols: slice,
               obs: Dict[str, torch.Tensor], steps: int) -> Dict[str, torch.Tensor]:
        """Copy a group's step inputs into the (T, B, ...) storage (allocated at the
        first step); returns the stored step, on which the policy then runs."""
        for k, v in obs.items():
            if k not in buf:
                buf[k] = torch.empty((steps, self.num_envs) + tuple(v.shape[1:]),
                                     dtype=v.dtype, device=self.device)
            buf[k][t, cols].copy_(v)
        return {k: v[t, cols] for k, v in buf.items()}

    def _act(self, g: int, obs: Dict[str, torch.Tensor]):
        """Policy step of group g on its stored inputs and its keyed action samples;
        advances the group's step count. Returns (action, log-prob, value)."""
        st = self._g[g]
        logits, value, st["h"] = self.policy(obs, st["h"], st["is_start"])
        action = self.sample_fn(logits, self.seed, st["t"], self._env_ids[g])
        st["t"] += 1
        logp = F.log_softmax(logits, -1).gather(1, action[:, None])[:, 0]
        return action, logp, value

    @torch.no_grad()
    def collect(self, num_steps: int) -> Tuple[Rollout, torch.Tensor, Dict[str, float]]:
        """A (T=num_steps, B) rollout, device act steps pipelined against the groups'
        env steps (B = every group's envs, in group order). Returns (rollout, bootstrap
        value (B,), episode metrics)."""
        if self._g is None:
            raise RuntimeError("call reset() first")
        G, B, dev = len(self.venvs), self.num_envs, self.device
        buf: Dict[str, torch.Tensor] = {}
        starts = torch.empty(num_steps, B, dtype=torch.bool, device=dev)
        actions = torch.empty(num_steps, B, dtype=torch.long, device=dev)
        logps = torch.empty(num_steps, B, device=dev)
        values = torch.empty(num_steps, B, device=dev)
        rewards = np.zeros((num_steps, B), np.float32)
        dones = np.zeros((num_steps, B), bool)
        valids = np.zeros((num_steps, B), bool)
        ep_metrics = {"success": [], "spl": [], "episode_len": []}
        h0 = self._h.clone()
        sent, recv = [0] * G, [0] * G

        def act_send(g: int) -> None:
            st, cols, t = self._g[g], self._cols[g], sent[g]
            with self.timer.stage("act"):
                obs = self._store(buf, t, cols,
                                  self._policy_obs(st["obs"], st["prev_action"]), num_steps)
                action, logps[t, cols], values[t, cols] = self._act(g, obs)
                action_np = action.cpu().numpy()  # waits for the device act step
            self.venvs[g].step_async(action_np)
            starts[t, cols], actions[t, cols] = st["is_start"], action
            st["sent_action"] = action
            sent[g] += 1

        def wait_record(g: int) -> None:
            st, cols, t = self._g[g], self._cols[g], recv[g]
            with self.timer.stage("env_step"):
                next_obs, reward, done, infos, valid = self.venvs[g].step_wait()
            rewards[t, cols], dones[t, cols], valids[t, cols] = reward, done, valid
            for inf in infos:
                if "success" in inf:
                    for k in ep_metrics:
                        ep_metrics[k].append(inf[k])
            st["obs"] = next_obs
            st["is_start"] = torch.from_numpy(done).to(dev)
            st["prev_action"] = torch.where(st["is_start"], self.venv_num_actions,
                                            st["sent_action"])
            recv[g] += 1

        act_send(0)
        for t in range(num_steps):
            for g in range(G):
                nxt = (g + 1) % G
                if nxt != g and not (t == num_steps - 1 and nxt == 0):
                    act_send(nxt)  # overlaps group g's env step
                wait_record(g)
                if nxt == g and t < num_steps - 1:  # G == 1: the sequential schedule
                    act_send(g)

        # Bootstrap value of the state after the last step, per group (no sample).
        last = torch.empty(B, device=dev)
        for g, st in enumerate(self._g):
            _, last[self._cols[g]], _ = self.policy(
                self._policy_obs(st["obs"], st["prev_action"]), st["h"], st["is_start"])
        to_dev = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        rollout = Rollout(obs=buf, is_start=starts, actions=actions, log_probs=logps,
                          values=values, rewards=to_dev(rewards), dones=to_dev(dones),
                          h0=h0, valid=to_dev(valids))
        metrics = {k: float(np.mean(v)) if v else 0.0 for k, v in ep_metrics.items()}
        metrics["episodes"] = float(len(ep_metrics["success"]))
        return rollout, last, metrics

    @torch.no_grad()
    def collect_dagger(self, num_steps: int, beta: float, rng: np.random.RandomState):
        """DAgger collection: act with a β-mixture of expert and learner actions and
        label every step with the expert's action (queried from the live workers before
        stepping). Returns (obs_seq, h0, starts, expert_seq, weights, metrics).

        weights (T, B) masks (obs, expert) pairs whose obs is stale: the previous
        step_wait fabricated this env's transition (a straggler or a respawn repeats
        the old obs while the worker's state moved on), or the expert query itself
        respawned a worker or drained a reply past an episode boundary. The mask of a
        transition fabricated at the last step of one call applies at step 0 of the
        next: it is carried across calls (the JAX package resets it every call).

        Needs a lockstep single pool (cutoff_fraction 1.0, no pipeline groups)."""
        if self._g is None:
            raise RuntimeError("call reset() first")
        if len(self.venvs) != 1:
            raise ValueError("DAgger collection does not pipeline groups")
        if getattr(self.venv, "cutoff_fraction", 1.0) < 1.0:
            raise ValueError("DAgger collection needs a lockstep pool (cutoff_fraction=1.0)")
        st, n, dev = self._g[0], self.venv.n, self.device
        buf: Dict[str, torch.Tensor] = {}
        starts = torch.empty(num_steps, n, dtype=torch.bool, device=dev)
        experts = np.zeros((num_steps, n), np.int64)
        weights = np.zeros((num_steps, n), np.float32)
        ep_metrics = {"success": [], "spl": [], "episode_len": []}
        h0 = st["h"].clone()
        for t in range(num_steps):
            # "act" = the device act step (with the frozen encode), "env_step" = the
            # simulators' work (the expert query and the env step).
            with self.timer.stage("env_step"):
                expert = self.venv.expert_actions()
            w = st["valid_prev"].copy()
            pend = getattr(self.venv, "_respawned_pending", ())
            if pend:
                w[list(pend)] = False
            with self.timer.stage("act"):
                obs = self._store(buf, t, slice(0, n),
                                  self._policy_obs(st["obs"], st["prev_action"]), num_steps)
                action, _, _ = self._act(0, obs)
                action_host = action.cpu().numpy()  # waits for the act step
            take_expert = rng.rand(n) < beta
            action_np = np.where(take_expert, expert, action_host).astype(np.int64)
            self.venv.step_async(action_np)
            starts[t] = st["is_start"]
            experts[t], weights[t] = expert, w
            with self.timer.stage("env_step"):
                next_obs, _reward, done, infos, valid = self.venv.step_wait()
            st["valid_prev"] = np.asarray(valid, bool)
            for inf in infos:
                if "success" in inf:
                    for k in ep_metrics:
                        ep_metrics[k].append(inf[k])
            st["obs"] = next_obs
            st["is_start"] = torch.from_numpy(done).to(dev)
            st["prev_action"] = torch.where(st["is_start"], self.venv_num_actions,
                                            torch.from_numpy(action_np).to(dev))
        metrics = {k: float(np.mean(v)) if v else 0.0 for k, v in ep_metrics.items()}
        metrics["episodes"] = float(len(ep_metrics["success"]))
        return (buf, h0, starts, torch.from_numpy(experts).to(dev),
                torch.from_numpy(weights).to(dev), metrics)
