"""Faults planted underneath the timed path, to show that `correct` catches them: in
the CPU tests (`tests/test_benchmark_faults.py`) at a test's size, and on the card at
a cell's own size (`limits.py --fault <name>`). Each fault is a context manager that
patches the program while it is open, and names itself on the cell (`cell.faults`), so
that a multi-rank run plants it in every rank. A fault takes its training form where
the traffic's driver trains (its `KIND`), and `applies` says which cells can have it.

`FAILURES` are not faults of the answer but of a rank: planted the same way, the last
rank raises, is killed or hangs in the window's second unit, which has to end the whole
run with no result (a hang within the traffic's `rank_timeout_s`), or loads a module
named `jax` there, which has to leave the run with no result once the window closes."""

from __future__ import annotations

import contextlib
import functools
import importlib
import os
import signal
import sys
import time
import types


def _owner(where: str):
    try:
        return importlib.import_module(where)
    except ModuleNotFoundError:
        mod, _, cls = where.rpartition(".")
        return getattr(importlib.import_module(mod), cls)


@contextlib.contextmanager
def _patched(where: str, attr: str, make):
    owner = _owner(where)
    raw = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
    setattr(owner, attr, make(raw))
    try:
        yield
    finally:
        setattr(owner, attr, raw)


def _alter_first(out):
    out = out.clone()
    out[0] = out[0].roll(1, dims=-1)
    return out


def _producer(config: dict):
    """Where the configuration's features are produced: its `producer`, `module:qualname`
    (as a layer file names a span), as `(module or class path, attribute)`."""
    mod, qual = config["producer"].split(":")
    owner, _, attr = qual.rpartition(".")
    return (f"{mod}.{owner}" if owner else mod), attr


def _trains(cell) -> bool:
    return getattr(importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}"),
                   "KIND", None) == "training"


def _named(fn, name: str = None):
    """A fault that names itself on the cell while it is planted."""
    name = name or fn.__name__

    @functools.wraps(fn)
    @contextlib.contextmanager
    def planted(cell):
        cell.faults.append(name)
        try:
            with fn(cell):
                yield
        finally:
            cell.faults.remove(name)
    return planted


@_named
def altered_answer(cell):
    """One frame's features altered where they are produced (the trunk; in training,
    the rollout's encode function)."""
    if _trains(cell):
        return _patched("embodied_clip_tpu_torch.training.frames.FrameEncoder", "__call__",
                        lambda f: lambda self, frames: _alter_first(f(self, frames)))
    return _patched(*_producer(cell.config),
                    lambda f: lambda *a, **k: _alter_first(f(*a, **k)))


@_named
def half_batch(cell):
    """Half of the batch left out: the encoder preprocesses half the frames; the PPO
    loss is taken over half of the envs (of each rank), its means over the rest."""
    if _trains(cell):
        def half(f):
            def loss(policy, rollout, adv, ret, cfg, reduce=None):
                b = rollout.actions.shape[1] // 2
                return f(policy, rollout.envs(slice(0, b)), adv[:, :b], ret[:, :b], cfg,
                         reduce)
            return loss
        return _patched("embodied_clip_tpu_torch.training.ddppo", "ppo_loss", half)
    return _patched("embodied_clip_tpu_torch.ops.preprocess.Preprocessor", "__call__",
                    lambda f: lambda self, x: f(self, x)[: x.shape[0] // 2])


@_named
def unchanged_state(cell):
    """A training step that returns its state unchanged: the optimiser does nothing."""
    return _patched("embodied_clip_tpu_torch.training.optim.ClippedAdam", "step",
                    lambda f: lambda self, grads=None: None)


@_named
def local_gradient(cell):
    """The exchange between cards left out on one rank: the last rank joins the
    gradient all-reduce (so that no rank waits for it) but steps on its own gradient."""
    from embodied_clip_tpu_torch.parallel import mesh

    def local(f):
        def all_sum_(tensors):
            tensors = list(tensors)
            if mesh.rank() == mesh.world_size() - 1:
                tensors = [t.clone() for t in tensors]
            f(tensors)
        return all_sum_
    return _patched("embodied_clip_tpu_torch.parallel.mesh", "all_sum_", local)


FAULTS = {"altered_answer": altered_answer, "half_batch": half_batch,
          "unchanged_state": unchanged_state, "local_gradient": local_gradient}


def applies(name: str, cell) -> bool:
    """Whether a cell can have the fault: a step's state only where it trains, the
    exchange only where it trains on more than one card."""
    if name == "unchanged_state":
        return _trains(cell)
    if name == "local_gradient":
        return _trains(cell) and cell.chips > 1
    return True


def _end_last_rank(how):
    def make(f):
        def unit(self, i):
            from embodied_clip_tpu_torch.parallel import mesh

            if i == 1 and mesh.world_size() > 1 and mesh.rank() == mesh.world_size() - 1:
                how()
            return f(self, i)
        return unit
    return lambda cell: _patched(f"benchmark.drivers.{cell.traffic['driver']}.Driver",
                                 "unit", make)


def _raise():
    raise RuntimeError("planted failure: the last rank raises in the window's second unit")


def _kill():
    os.kill(os.getpid(), signal.SIGKILL)


def _hang():
    time.sleep(3600)


def _load_jax():
    sys.modules.setdefault("jax", types.ModuleType("jax"))


FAILURES = {name: _named(_end_last_rank(how), name) for name, how in
            (("rank_raises", _raise), ("rank_killed", _kill), ("rank_hangs", _hang),
             ("rank_loads_jax", _load_jax))}
