"""Experiment-config registry: dataclass configs addressable by name (port of
`embodied_clip_tpu/config/experiments.py`).

Replaces the reference's three config idioms (SURVEY.md §5): argparse probing flags
(train.py:119-134), allenact experiment-classes-by-module-tag
(baselines_robothor_objectnav.md:48-51), habitat YAML grids (baselines_habitat.md:63-75).
The port registers the JAX package's 29 names: the probing grid (`probe_{prediction}_
{embedding}`, `ProbeExperiment`) and the RL experiments (`config/rl_experiments.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

__all__ = ["Experiment", "ProbeExperiment", "register", "list_experiments", "get_experiment"]

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


# ------------------------------------------------------------------------- probing

@dataclasses.dataclass
class ProbeExperiment(Experiment):
    """Probing grid: 3 embeddings × 4 predictions (reference train.py choices).
    `device` is the port's own field: the card unless the caller asks for the CPU."""

    embedding_type: str = "clip_avgpool"
    prediction_type: str = "object_presence"
    data_dir: str = "data"
    log_dir: str = "logs/"
    max_epochs: int = 250
    batch_size: int = 128
    lr: float = 1e-3
    device: str = "cuda"

    def _setup(self, log_dir, ckpt_dir):
        from embodied_clip_tpu_torch.data.probing import ProbeDataModule
        from embodied_clip_tpu_torch.training.supervised import ProbeTrainConfig, ProbeTrainer

        dm = ProbeDataModule(
            self.data_dir, self.embedding_type, self.prediction_type, self.batch_size
        ).setup()
        trainer = ProbeTrainer(ProbeTrainConfig(
            embedding_type=self.embedding_type, prediction_type=self.prediction_type,
            lr=self.lr, batch_size=self.batch_size, max_epochs=self.max_epochs,
            log_dir=log_dir, ckpt_dir=ckpt_dir, device=self.device,
        ))
        return dm, trainer

    def train(self, output_dir: str, ckpt: Optional[str] = None) -> dict:
        """Fit, then test with the best-val params; the best params go to
        `{output_dir}/best.pt`."""
        dm, trainer = self._setup(self.log_dir, output_dir)
        val = trainer.fit(dm)
        test = trainer.test(dm)
        return {"val": val, "test": test}

    def evaluate(self, output_dir: str, ckpt: Optional[str] = None) -> dict:
        """Eval-only pass: restore a checkpoint and score the test split. No training
        step runs (reference eval flow: restore + trainer.test, train.py:170-174).
        `ckpt` defaults to the best-val checkpoint that `train` wrote under
        `output_dir`."""
        import os

        if ckpt is None:
            best = os.path.join(output_dir, "best.pt")
            if not os.path.isfile(best):
                raise FileNotFoundError(
                    f"--eval needs a checkpoint: none given and {best!r} absent")
            ckpt = best
        dm, trainer = self._setup(None, None)
        x0, _ = next(dm.batches("test", shuffle=False))
        trainer.load(ckpt, x0)
        return {"test": trainer.test(dm, use_best=False)}


def _register_probe_grid():
    from embodied_clip_tpu_torch.models.probes import EMBEDDING_TYPES, PREDICTION_TYPES

    for pred in PREDICTION_TYPES:
        embs = ("imagenet_avgpool", "clip_avgpool") if pred == "object_localization" \
            else EMBEDDING_TYPES
        for emb in embs:
            name = f"probe_{pred}_{emb}"

            def factory(e=emb, p=pred, n=name):
                return ProbeExperiment(name=n, embedding_type=e, prediction_type=p)

            _REGISTRY[name] = factory


_register_probe_grid()


# ------------------------------------------------------------------------------ RL
# ObjectNav / PointNav / Rearrangement experiments are registered by
# embodied_clip_tpu_torch.config.rl_experiments.

def _register_rl():
    from embodied_clip_tpu_torch.config import rl_experiments  # noqa: F401


_register_rl()
