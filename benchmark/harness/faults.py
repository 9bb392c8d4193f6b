"""Faults planted underneath the timed path, to show that `correct` catches them: in
the CPU tests (`tests/test_benchmark_faults.py`) at a test's size, and on the card at
a cell's own size (`limits.py --fault <name>`). Each fault is a context manager that
patches the program while it is open."""

from __future__ import annotations

import contextlib
import importlib


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


def altered_answer(cell):
    """One frame's features altered where they are produced (the trunk; in training,
    the rollout's encode function)."""
    if cell.traffic["driver"] == "ddppo":
        return _patched("embodied_clip_tpu_torch.training.frames.FrameEncoder", "__call__",
                        lambda f: lambda self, frames: _alter_first(f(self, frames)))
    return _patched(*_producer(cell.config),
                    lambda f: lambda *a, **k: _alter_first(f(*a, **k)))


def half_batch(cell):
    """Half of the batch left out: the encoder preprocesses half the frames; the PPO
    loss is taken over half of the envs, its means over the rest."""
    if cell.traffic["driver"] == "ddppo":
        def half(f):
            def loss(policy, rollout, adv, ret, cfg, reduce=None):
                b = rollout.actions.shape[1] // 2
                return f(policy, rollout.envs(slice(0, b)), adv[:, :b], ret[:, :b], cfg,
                         reduce)
            return loss
        return _patched("embodied_clip_tpu_torch.training.ddppo", "ppo_loss", half)
    return _patched("embodied_clip_tpu_torch.ops.preprocess.Preprocessor", "__call__",
                    lambda f: lambda self, x: f(self, x)[: x.shape[0] // 2])


def unchanged_state(cell):
    """A training step that returns its state unchanged: the optimiser does nothing."""
    return _patched("embodied_clip_tpu_torch.training.optim.ClippedAdam", "step",
                    lambda f: lambda self, grads=None: None)


FAULTS = {"altered_answer": altered_answer, "half_batch": half_batch,
          "unchanged_state": unchanged_state}
