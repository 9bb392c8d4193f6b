"""Checkpointing on `torch.save` / `torch.load(weights_only=True)` (port of
`embodied_clip_tpu/utils/checkpoint.py`, which is built on orbax).

Covers the reference's two checkpoint styles (SURVEY.md §5):
  - best-val model checkpointing for probes (PL ModelCheckpoint monitor=val_loss
    mode=min, reference train.py:160-165; test restores best, train.py:170-174)
  - step-stamped train state (params + opt state + env-step counter) for RL, matching
    the `…__stage_00__steps_N.pt` convention (baselines_robothor_objectnav.md:58).

A checkpoint is one file holding a tree of dicts (string keys) and lists whose leaves
are tensors or plain numbers: nothing that needs pickle, so every file loads with
`weights_only=True`. A leaf's key path joins its dict keys and list indices with "/"
(`params/gru.weight_ih`, `opt_state/mu/0`), dict keys in sorted order, as the JAX package
names orbax tree paths. Files are written to a temporary name and renamed, so a run cut
mid-save leaves the previous checkpoint intact. JAX's orbax checkpoints do not load here.
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_pytree", "restore_pytree", "restore_params", "BestCheckpointer",
           "StepCheckpointer"]


def save_pytree(path: str, tree: Any) -> None:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def restore_pytree(path: str, target: Optional[Any] = None) -> Any:
    """The tree saved at `path`, its tensors on the CPU; with `target`, checked
    against it (`_check_matches_template`) and each tensor moved to the device of
    `target`'s leaf at the same key path."""
    path = os.path.abspath(path)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if target is None:
        return raw
    _check_matches_template(target, raw, path)
    return _place(target, raw)


def _items(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree, key=str)]
    return [(str(i), v) for i, v in enumerate(tree)]


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs in the JAX package's order: dict keys sorted."""
    if isinstance(tree, (dict, list, tuple)):
        out = []
        for k, v in _items(tree):
            out.extend(_flatten(v, f"{prefix}/{k}" if prefix else k))
        return out
    return [(prefix, tree)]


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def _place(target, raw):
    """`raw` in `target`'s structure, each tensor on the device of `target`'s."""
    if isinstance(target, dict):
        return {k: _place(v, raw[k]) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_place(t, r) for t, r in zip(target, raw))
    if isinstance(target, torch.Tensor) and isinstance(raw, torch.Tensor):
        return raw.to(target.device)
    return raw


def restore_params(path: str, params_template: Any) -> Any:
    """Restore ONLY policy/model params from a checkpoint of either layout: a bare
    params tree (a policy's state_dict), or a full train state ({"params",
    "opt_state", ...} — the step-stamped RL checkpoints). This is what makes
    fake-trained checkpoints loadable by thor/habitat-backend learners (`ckpt=`): the
    action spaces match (envs/gridworld.py ACTIONS == envs/thor.py OBJECTNAV_ACTIONS),
    so only the params subtree transfers.

    Structure checks are key-path-aware: two architectures with coincidentally equal
    flat shape lists cannot silently cross-load — the first divergent key path is
    named in the error. Returns the template's structure with the checkpoint's values
    in the template's dtypes, on its devices."""
    raw = restore_pytree(path)
    if isinstance(raw, dict) and "params" in raw:
        raw = raw["params"]
    flat_t, flat_r = _flatten(params_template), _flatten(raw)
    if len(flat_t) != len(flat_r):
        raise ValueError(
            f"checkpoint param tree has {len(flat_r)} leaves, expected "
            f"{len(flat_t)} — incompatible policy architecture")
    for (st, t), (sr, v) in zip(flat_t, flat_r):
        if st != sr:
            raise ValueError(
                f"checkpoint param tree diverges at '{sr}' (expected '{st}') "
                "— incompatible policy architecture")
        if _shape(v) != _shape(t):
            raise ValueError(
                f"checkpoint leaf '{st}' shape {_shape(v)} != expected "
                f"{_shape(t)} — incompatible policy architecture")
    return _cast(params_template, raw)


def _cast(template, raw):
    if isinstance(template, dict):
        return {k: _cast(v, raw[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_cast(t, r) for t, r in zip(template, raw))
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(raw).to(device=template.device, dtype=template.dtype)
    return raw


def _host_copy(tree):
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree.detach().to("cpu", copy=True) if isinstance(tree, torch.Tensor) else tree


class BestCheckpointer:
    """Keep the params minimizing (mode "min") or maximizing (any other mode) a
    monitored metric; optionally persist them to `directory/best.pt`."""

    def __init__(self, directory: Optional[str] = None, mode: str = "min"):
        self.directory = directory
        self.sign = 1.0 if mode == "min" else -1.0
        self.best_value = math.inf
        self.best_params = None
        self.best_tag = None

    def update(self, value: float, params: Any, tag: str = "") -> bool:
        if self.sign * value < self.best_value:
            self.best_value = self.sign * value
            # Snapshot to the host: the live parameters change in place at the next
            # optimizer step.
            self.best_params = _host_copy(params)
            self.best_tag = tag
            if self.directory is not None:
                save_pytree(os.path.join(self.directory, "best.pt"), self.best_params)
            return True
        return False


class StepCheckpointer:
    """Step-stamped train-state checkpoints (`{prefix}__steps_{step:012d}.pt`) with
    latest-restore."""

    def __init__(self, directory: str, prefix: str = "ckpt"):
        self.directory = os.path.abspath(directory)
        self.prefix = prefix
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}__steps_{step:012d}.pt")

    def save(self, step: int, state: Any) -> str:
        path = self._path(step)
        save_pytree(path, state)
        return path

    def latest_step(self) -> Optional[int]:
        pat = re.compile(rf"{re.escape(self.prefix)}__steps_(\d+)(?:\.pt)?$")
        steps = [
            int(m.group(1))
            for name in os.listdir(self.directory)
            if (m := pat.match(name))
        ]
        return max(steps) if steps else None

    def restore_latest(self, target: Optional[Any] = None):
        """(step, state) of the latest checkpoint, or (None, None). With `target`, the
        state must be THIS experiment's train-state tree (key paths and shapes): a
        reused output dir holding another config's checkpoints otherwise restores
        mismatched tensors that only fail later, deep inside a rollout."""
        step = self.latest_step()
        if step is None:
            return None, None
        return step, restore_pytree(self._path(step), target)


def _check_matches_template(template: Any, restored: Any, path: str) -> None:
    flat_t, flat_r = _flatten(template), _flatten(restored)
    if len(flat_t) != len(flat_r):
        raise ValueError(
            f"checkpoint {path} has {len(flat_r)} leaves, expected "
            f"{len(flat_t)}: the output dir holds a checkpoint from a "
            "different experiment config — use a fresh output dir (or pass "
            "the old checkpoint explicitly via --ckpt)")
    for (st, t), (sr, v) in zip(flat_t, flat_r):
        if st != sr:
            raise ValueError(
                f"checkpoint {path} diverges at leaf '{sr}' (expected '{st}') "
                "— the output dir holds a checkpoint from a different "
                "experiment config; use a fresh output dir")
        if _shape(v) != _shape(t):
            raise ValueError(
                f"checkpoint {path} leaf '{st}' has shape {_shape(v)}, "
                f"expected {_shape(t)} — the output dir holds a checkpoint "
                "from a different experiment config (e.g. another encoder); "
                "use a fresh output dir")
