"""Vectorized host-env worker pool, process-level parallelism on CPU hosts (port of
`embodied_clip_tpu/envs/vector.py`).

The counterpart of allenact/habitat's vectorized task samplers (the reference
runs 40 env processes per machine for Rearrangement, baselines_ithor_rearrangement.md:9).
Each worker process owns one simulator instance; the pool steps them asynchronously
and assembles contiguous uint8 frame batches for device transfer.

Straggler cutoff (DD-PPO's signature preemption tolerance, SURVEY.md §2.4): `step_wait`
can return once `cutoff_fraction` of workers have delivered, repeating each straggler's
previous observation and masking it via the returned 'valid' flags, so one slow
simulator never stalls the card.

When a C++ shared-memory frame ring (native/frame_ring) is built, workers write frames
directly into shared memory instead of pickling them through pipes.

Workers start from a fork server, not by forking the caller as the JAX package does:
by the time a learner builds its pool (or respawns a worker mid-training) its process
holds a CUDA context and the threads of torch and the CUDA driver, and a fork of a
threaded process can inherit a lock held by a thread that does not exist in the child.
The fork server is a fresh interpreter, started on first use, that imports this module
(and so torch, which initialises no CUDA) once; every worker, the respawned ones
included, is forked from it, so it starts in milliseconds and never holds or touches a
CUDA context. Env factories are therefore pickled: pass a class or a
`functools.partial`, not a lambda. The server, and the resource tracker it starts,
outlive every pool and end only after the process that started them has ended: a
program that must leave no process behind calls `stop_fork_server()` once its last
pool is closed.
"""

from __future__ import annotations

import multiprocessing as mp
import time
from multiprocessing import forkserver, resource_tracker
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from embodied_clip_tpu_torch.native.frame_ring import FrameRing, frame_ring_available

__all__ = ["VectorEnv", "stop_fork_server"]


def stop_fork_server() -> None:
    """Stop the fork server the workers start from and the resource tracker it
    started, and wait for both to exit. Call it only when no pool is open; a pool
    built afterwards starts a new server."""
    forkserver._forkserver._stop()  # first: the server holds the tracker's pipe
    resource_tracker._resource_tracker._stop()


def _worker(remote, env_fn, ring_info, slot):
    try:
        env = env_fn()
    except Exception as e:  # report WHY (e.g. simulator not installed) —
        # otherwise the parent only sees a dead pipe (ConnectionResetError)
        try:
            remote.send(("error", f"{type(e).__name__}: {e}"))
        finally:
            return
    ring = None
    if ring_info is not None:
        ring = FrameRing.attach(*ring_info)
    try:
        while True:
            cmd, data = remote.recv()
            if cmd == "reset":
                obs = env.reset()
                if ring is not None and "visual" in obs:
                    ring.write(slot, obs["visual"])
                    obs = {k: v for k, v in obs.items() if k != "visual"}
                remote.send(("obs", obs))
            elif cmd == "step":
                obs, reward, done, info = env.step(int(data))
                if ring is not None and "visual" in obs:
                    ring.write(slot, obs["visual"])
                    obs = {k: v for k, v in obs.items() if k != "visual"}
                remote.send(("trans", (obs, reward, done, info)))
            elif cmd == "expert":
                # DAgger labeling: the env's per-instance expert (envs must expose
                # expert_action() for imitation backends, e.g. THORRearrangeEnv).
                remote.send(("expert", int(env.expert_action())))
            elif cmd == "close":
                env.close()
                remote.send(("closed", None))
                return
    except (KeyboardInterrupt, EOFError):
        env.close()
    except Exception as e:  # report the real error before dying — otherwise
        # the parent only sees a context-free dead pipe
        try:
            remote.send(("error", f"{type(e).__name__}: {e}"))
        finally:
            raise


class VectorEnv:
    """Pool of worker processes, batched numpy interface."""

    def __init__(self, env_fns: Sequence[Callable], frame_shape: Optional[Tuple[int, int, int]] = None,
                 cutoff_fraction: float = 1.0, cutoff_timeout_s: float = 30.0,
                 respawn_timeout_s: float = 60.0, max_steps: Optional[int] = None):
        """`max_steps` is the envs' episode horizon, where the caller knows it
        (`training/evaluate.evaluate_policy_host` sizes its step budget from it)."""
        self.n = len(env_fns)
        self.max_steps = max_steps
        self.cutoff_fraction = cutoff_fraction
        self.cutoff_timeout_s = cutoff_timeout_s
        # distinct from the step cutoff: a worker slower than the cutoff is a
        # straggler; one silent past THIS deadline is declared dead and respawned
        self.respawn_timeout_s = respawn_timeout_s
        self._env_fns = list(env_fns)
        self._ctx = mp.get_context("forkserver")
        # Takes effect when the server starts (the first pool of the process).
        self._ctx.set_forkserver_preload([__name__])
        self.ring = None
        self._ring_info = None
        if frame_shape is not None and frame_ring_available():
            self.ring = FrameRing.create(self.n, frame_shape)
            self._ring_info = self.ring.attach_info()
        self.remotes: List = [None] * self.n
        self.procs: List = [None] * self.n
        for i in range(self.n):
            self._spawn(i)
        self.num_actions = None
        self._last_obs: List[Optional[Dict]] = [None] * self.n
        self._straggler_pending: List[int] = []
        # Workers that crossed an episode boundary the collector never saw —
        # respawned (fresh env) or a drained straggler reply with done=True.
        # Their NEXT reply answers an action computed from stale pre-boundary
        # obs and executed in the new episode, so step_wait records it invalid
        # and done=True (the collector resets the GRU carry and prev_action
        # instead of bleeding state across the boundary).
        self._respawned_pending: set = set()
        self.respawn_count = 0

    def _spawn(self, i: int) -> None:
        parent, child = self._ctx.Pipe()
        p = self._ctx.Process(
            target=_worker, args=(child, self._env_fns[i], self._ring_info, i),
            daemon=True,
        )
        p.start()
        self.remotes[i] = parent
        self.procs[i] = p

    def _respawn(self, i: int) -> None:
        """Replace a dead/hung worker with a fresh process (elastic recovery,
        SURVEY.md §5 failure-detection row). The fresh env resets; its first
        transition after respawn is already masked invalid by the caller."""
        try:
            self.procs[i].terminate()
        except Exception:
            pass
        self.procs[i].join(timeout=2)
        try:
            self.remotes[i].close()
        except Exception:
            pass
        self._spawn(i)
        self.respawn_count += 1
        self._respawned_pending.add(i)
        self.remotes[i].send(("reset", None))
        self._last_obs[i] = self._recv_obs(i, "obs")

    def _worker_dead(self, i: int) -> bool:
        return not self.procs[i].is_alive() and not self.remotes[i].poll(0)

    def _drain_stragglers(self) -> None:
        """Collect (or give up on) replies still owed from a previous cutoff.
        Non-blocking with a deadline: a dead or hung worker is respawned instead
        of hanging the pool (VERDICT r2 weak #6)."""
        pending = list(self._straggler_pending)
        self._straggler_pending = []
        # One SHARED deadline bounds the whole drain (k simultaneously hung
        # workers stall the pool once, not k times), but every worker is
        # guaranteed at least one poll even after the deadline passes — a
        # healthy worker whose reply is already sitting in the pipe must never
        # be respawned just because an earlier straggler ate the budget.
        deadline = time.monotonic() + self.respawn_timeout_s
        for i in pending:
            got = False
            while True:
                if self.remotes[i].poll(0.005):
                    try:
                        tag, payload = self.remotes[i].recv()
                    except (EOFError, OSError):
                        break
                    if tag == "error":
                        raise RuntimeError(
                            f"env worker {i} failed: {payload}")
                    obs = payload[0]
                    if self.ring is not None:
                        obs = dict(obs)
                        obs["visual"] = self.ring.read(i)
                    self._last_obs[i] = obs
                    if tag == "trans" and payload[2]:
                        # The delayed reply crossed an episode boundary (done
                        # =True) the collector never saw: the action it is
                        # about to execute was computed from pre-done obs, so
                        # mask its next transition invalid + done to reset
                        # recurrent state (same contract as a respawn).
                        self._respawned_pending.add(i)
                    got = True
                    break
                if self._worker_dead(i) or time.monotonic() >= deadline:
                    break
            if not got:
                self._respawn(i)

    # -------------------------------------------------------------------- lifecycle

    def reset(self) -> Dict[str, np.ndarray]:
        # Drain replies still owed from a previous cutoff first — otherwise a
        # stale step reply would be misread as the reset observation.
        self._drain_stragglers()
        sent = []
        for i, r in enumerate(self.remotes):
            try:
                r.send(("reset", None))
                sent.append(i)
            except (BrokenPipeError, OSError):
                # Died idle (after its last successful reply): respawn — the
                # fresh worker resets itself and its obs lands in _last_obs.
                self._respawn(i)
        # Workers reset concurrently, so one shared deadline bounds the wait;
        # a worker that dies INSIDE env.reset (after accepting the command) or
        # hangs past the deadline is respawned instead of crashing the pool.
        deadline = time.monotonic() + self.respawn_timeout_s
        for i in sent:
            ok = False
            while True:
                if self.remotes[i].poll(0.01):
                    try:
                        self._last_obs[i] = self._recv_obs(i, "obs")
                        ok = True
                    except (EOFError, OSError):
                        pass
                    break
                if self._worker_dead(i) or time.monotonic() >= deadline:
                    break
            if not ok:
                self._respawn(i)
        # A reset realigns every column to an episode start; no transition
        # straddles a respawn boundary anymore.
        self._respawned_pending.clear()
        return self._stack(self._last_obs)

    def _recv_obs(self, i, kind):
        tag, payload = self.remotes[i].recv()
        if tag == "error":
            # Deterministic construction failure (e.g. simulator not
            # installed): fail loudly with the worker's own message instead of
            # respawn-looping into a bare ConnectionResetError.
            raise RuntimeError(f"env worker {i} failed to construct its "
                               f"environment: {payload}")
        if kind == "obs":
            obs = payload
        else:
            obs = payload[0]
        if self.ring is not None:
            obs = dict(obs)
            obs["visual"] = self.ring.read(i)
        return obs if kind == "obs" else (obs,) + payload[1:]

    # ------------------------------------------------------------------------ step

    def step_async(self, actions: np.ndarray) -> None:
        # Drain any straggler replies from a previous cutoff FIRST — otherwise a stale
        # reply would be mistaken for the response to the action sent below.
        self._drain_stragglers()
        for r, a in zip(self.remotes, actions):
            try:
                r.send(("step", int(a)))
            except (BrokenPipeError, OSError):
                pass  # dead worker: step_wait marks it invalid, then it respawns

    def step_wait(self):
        """Gather transitions; with cutoff_fraction < 1, return once enough workers
        responded (stragglers repeat their previous obs, valid=False)."""
        need = max(1, int(np.ceil(self.cutoff_fraction * self.n)))
        deadline = time.monotonic() + self.cutoff_timeout_s
        pending = set(range(self.n))
        results: Dict[int, Tuple] = {}
        while pending and (len(results) < need or self.cutoff_fraction >= 1.0):
            progressed = False
            for i in list(pending):
                if self.remotes[i].poll(0.001):
                    try:
                        tag, payload = self.remotes[i].recv()
                    except (EOFError, OSError):
                        pending.discard(i)  # died mid-send → straggler path
                        progressed = True
                        continue
                    if tag == "error":
                        # The worker hit a real exception (not a process
                        # death): surface its message instead of training on
                        # silence or respawn-looping.
                        raise RuntimeError(f"env worker {i} failed: {payload}")
                    obs, reward, done, info = payload
                    if self.ring is not None:
                        obs = dict(obs)
                        obs["visual"] = self.ring.read(i)
                    results[i] = (obs, reward, done, info)
                    self._last_obs[i] = obs
                    pending.discard(i)
                    progressed = True
                elif self._worker_dead(i):
                    # Fail fast: no reply will ever come; route through the
                    # straggler path so the drain respawns it.
                    pending.discard(i)
                    progressed = True
            if len(results) >= need and self.cutoff_fraction < 1.0:
                break
            if not progressed and time.monotonic() > deadline:
                break

        obs_list, rewards, dones, infos, valid = [], [], [], [], []
        for i in range(self.n):
            if i in results and i in self._respawned_pending:
                # First reply after a respawn: the action was computed from a
                # stale pre-respawn obs and executed in a fresh episode —
                # incoherent as training data. Mask it invalid and mark the
                # episode boundary so the caller resets recurrent state.
                self._respawned_pending.discard(i)
                obs_list.append(results[i][0])
                rewards.append(0.0); dones.append(True); infos.append({})
                valid.append(False)
            elif i in results:
                o, r, d, inf = results[i]
                obs_list.append(o); rewards.append(r); dones.append(d)
                infos.append(inf); valid.append(True)
            else:
                # Straggler: repeat last obs, zero transition; its real reply is
                # drained on the next step_wait call.
                obs_list.append(self._last_obs[i])
                rewards.append(0.0); dones.append(False); infos.append({})
                valid.append(False)
        self._straggler_pending = [i for i in range(self.n) if i not in results]
        return (self._stack(obs_list), np.asarray(rewards, np.float32),
                np.asarray(dones, bool), infos, np.asarray(valid, bool))

    def step(self, actions):
        self.step_async(actions)
        return self.step_wait()

    def expert_actions(self) -> np.ndarray:
        """Query every worker's expert action for its CURRENT state (DAgger).

        Routed through the same straggler/respawn machinery as stepping: owed
        step replies are drained FIRST so they cannot be misread as expert
        replies (pipe-protocol desync), dead workers are respawned (the fresh
        episode's expert is returned — one noisy label rather than a crash),
        and any stale non-expert reply that still slips through is consumed
        and the pipe re-queried."""
        self._drain_stragglers()
        out = np.zeros(self.n, np.int32)
        deadline = time.monotonic() + self.respawn_timeout_s

        def respawn_and_ask(i):
            self._respawn(i)
            self.remotes[i].send(("expert", None))
            # fresh worker, empty pipe: a blocking recv is safe here (the same
            # trust _respawn itself places in its post-reset recv)
            return self.remotes[i].recv()[1]

        # Broadcast all queries FIRST (as step_async does) so the n workers'
        # expert computations — shortest paths can cost 50-200 ms each —
        # overlap instead of serializing behind each gather.
        dead_at_send = []
        for i, r in enumerate(self.remotes):
            try:
                r.send(("expert", None))
            except (BrokenPipeError, OSError):
                dead_at_send.append(i)
        for i in dead_at_send:
            out[i] = respawn_and_ask(i)
        for i in range(self.n):
            if i in dead_at_send:
                continue
            got = False
            while not got:
                if self.remotes[i].poll(0.01):
                    try:
                        tag, payload = self.remotes[i].recv()
                    except (EOFError, OSError):
                        out[i] = respawn_and_ask(i)
                        break
                    if tag == "expert":
                        out[i] = payload
                        got = True
                    elif tag == "error":
                        raise RuntimeError(f"env worker {i} failed: {payload}")
                    else:
                        # stale step/reset reply that slipped past the drain:
                        # record its obs and keep waiting for the expert reply
                        obs = payload[0] if tag == "trans" else payload
                        if self.ring is not None:
                            obs = dict(obs)
                            obs["visual"] = self.ring.read(i)
                        self._last_obs[i] = obs
                elif self._worker_dead(i) or time.monotonic() >= deadline:
                    out[i] = respawn_and_ask(i)
                    break
        return out

    @staticmethod
    def _stack(obs_list: List[Dict]) -> Dict[str, np.ndarray]:
        keys = obs_list[0].keys()
        return {k: np.stack([o[k] for o in obs_list]) for k in keys}

    def close(self):
        for r in self.remotes:
            try:
                r.send(("close", None))
            except (BrokenPipeError, OSError):
                pass
        for p in self.procs:
            p.join(timeout=2)
            if p.is_alive():
                p.terminate()
                p.join(timeout=2)
            if p.is_alive():
                p.kill()
                p.join()
        if self.ring is not None:
            self.ring.close()
