"""Multi-process dry run of the DD-PPO step on the CPU (the port's analogue of
`__graft_entry__.py:dryrun_multichip`).

    python -c "from embodied_clip_tpu_torch.parallel import dryrun; dryrun.dryrun_multichip(2)"

`run_ranks(n, fn, *args)` starts n spawned processes joined in a gloo group on a free
localhost port (an NCCL group, one card a process, with `device="cuda"`), runs
`fn(*args)` in each and returns their results in rank order.
`dryrun_multichip(n)` runs one DD-PPO iteration in n such processes at tiny shapes
(GridNav size 5, episodes of 8 steps, hidden 32, rollout 2, 2 envs a process, 1 epoch).
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import traceback
from typing import Any, Callable, List

__all__ = ["free_port", "run_ranks", "dryrun_multichip"]


def free_port() -> int:
    """A free localhost TCP port for a process group's rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, n: int, port: int, args, results, device) -> None:
    import torch
    import torch.distributed as dist

    from embodied_clip_tpu_torch.parallel.distributed import initialize_distributed

    torch.set_num_threads(1)
    try:
        initialize_distributed(f"localhost:{port}", n, rank, device=device)
        results.put((rank, True, fn(*args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(n: int, fn: Callable, *args, timeout: float = 300.0,
              device: str = "cpu") -> List[Any]:
    """`fn(*args)` in n processes (fn and args must pickle), joined by gloo, or by NCCL
    with rank r on card r when `device` is "cuda"; results in rank order. Raises if a
    process fails or the run outlasts `timeout` seconds."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    # Not daemonic: a rank may start processes of its own (a host backend's VectorEnv
    # workers). The finally clause below ends every rank.
    procs = [ctx.Process(target=_rank_main, args=(fn, r, n, port, args, results, device))
             for r in range(n)]
    for p in procs:
        p.start()
    out, errors = {}, []
    try:
        for _ in range(n):
            rank, ok, value = results.get(timeout=timeout)
            if not ok:
                errors.append(f"rank {rank}:\n{value}")
                break
            out[rank] = value
    except queue.Empty:
        errors.append(f"no result within {timeout} s")
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"run_ranks({n}) failed (exit codes "
                           f"{[p.exitcode for p in procs]}): " + "\n".join(errors))
    return [out[r] for r in range(n)]


def _dryrun_rank() -> float:
    import torch

    from embodied_clip_tpu_torch.envs.gridworld import GridNavEnv
    from embodied_clip_tpu_torch.models.policy import ActorCritic
    from embodied_clip_tpu_torch.parallel import mesh
    from embodied_clip_tpu_torch.training.ddppo import DDPPOConfig, DDPPOLearner
    from embodied_clip_tpu_torch.training.ppo import PPOConfig

    env = GridNavEnv(size=5, max_steps=8)
    policy = ActorCritic(env.num_actions, (env.view, env.view, env.obs_channels),
                         goal_kind="object_embed", num_goal_classes=env.num_classes,
                         hidden=32)
    cfg = DDPPOConfig(rollout_len=2, env_batch=2 * mesh.world_size(),
                      ppo=PPOConfig(epochs=1))
    learner = DDPPOLearner(env, policy, cfg, device="cpu")
    generator = torch.Generator().manual_seed(mesh.rank())  # each process's own envs
    act = learner.init(generator)
    act, metrics = learner.train_iteration(act, generator)
    loss = mesh.host_scalar(metrics["loss"])
    if loss != loss:
        raise RuntimeError("dryrun: the loss is NaN")
    return loss


def dryrun_multichip(n_devices: int) -> None:
    """One DD-PPO iteration in `n_devices` gloo processes on the CPU; prints the
    global loss."""
    losses = run_ranks(n_devices, _dryrun_rank)
    if len(set(losses)) != 1:
        raise RuntimeError(f"dryrun: the processes disagree on the global loss: {losses}")
    print(f"dryrun_multichip({n_devices}): ok, loss={losses[0]:.4f}")
