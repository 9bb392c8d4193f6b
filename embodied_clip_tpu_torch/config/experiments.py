"""Experiment-config registry: dataclass configs addressable by name (port of
`embodied_clip_tpu/config/experiments.py`).

Replaces the reference's three config idioms (SURVEY.md §5): argparse probing flags
(train.py:119-134), allenact experiment-classes-by-module-tag
(baselines_robothor_objectnav.md:48-51), habitat YAML grids (baselines_habitat.md:63-75).
So far the port registers the RL experiments (`config/rl_experiments.py`) under the JAX
package's names; the probing grid (`probe_*`) is still to be ported.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

__all__ = ["Experiment", "register", "list_experiments", "get_experiment"]

_REGISTRY: Dict[str, Callable[[], "Experiment"]] = {}


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def list_experiments() -> List[str]:
    return sorted(_REGISTRY)


def get_experiment(name: str, overrides: Optional[List[str]] = None) -> "Experiment":
    """The registered experiment `name` with `key=value` overrides applied: `none` or
    `null` sets None; otherwise the value takes the type of a non-None default (a bool
    is true for `1` or `true`), and a None default's value is tried as int, then float,
    then kept as a string. A misspelt key raises AttributeError, an unknown name
    KeyError."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown experiment {name!r}; run list-configs")
    exp = _REGISTRY[name]()
    for ov in overrides or []:
        key, _, value = ov.partition("=")
        cur = getattr(exp, key)  # raises AttributeError on typo'd keys
        if value.lower() in ("none", "null"):
            setattr(exp, key, None)
            continue
        if cur is not None:
            typ = type(cur)
            setattr(exp, key,
                    typ(value) if typ is not bool else value.lower() in ("1", "true"))
            continue
        # None-default fields carry no type — infer from the literal
        # (int → float → str) so numeric knobs don't arrive as strings.
        for typ in (int, float):
            try:
                setattr(exp, key, typ(value))
                break
            except ValueError:
                continue
        else:
            setattr(exp, key, value)
    return exp


@dataclasses.dataclass
class Experiment:
    name: str = "base"

    def train(self, output_dir: str, ckpt: Optional[str] = None) -> dict:
        raise NotImplementedError

    def evaluate(self, output_dir: str, ckpt: Optional[str] = None) -> dict:
        raise NotImplementedError


# ------------------------------------------------------------------------------ RL
# ObjectNav / PointNav / Rearrangement experiments are registered by
# embodied_clip_tpu_torch.config.rl_experiments.

def _register_rl():
    from embodied_clip_tpu_torch.config import rl_experiments  # noqa: F401


_register_rl()
