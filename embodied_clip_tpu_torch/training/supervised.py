"""Supervised probe trainer (port of `embodied_clip_tpu/training/supervised.py`): the
reference's training contract (train.py:136-174): Adam lr 1e-3, batch 128, up to 250
epochs, validation twice per epoch, best-val-loss checkpointing, test on the best
checkpoint, TensorBoard scalars train_loss/val_loss/val_acc/test_loss/test_acc.

One optimizer step is `probe_train_step`, a plain function of the probe's parameters,
the optimizer state and one batch (no host sync inside). Adam is optax's
(`training/optim.Adam`). The loss is read on the host only where it is logged, every
`log_every` steps; the evaluation metrics once per pass.

Data parallelism (`data_parallel=True`) runs in a `torch.distributed` group, one process
per card, as the port's other learners do: every process reads the same batches, takes
its `parallel/mesh.shard_batch` slice of each batch that divides evenly over the
processes and averages the gradients over them (one flat all-reduce); an indivisible
batch is computed whole on every process, as the JAX package replicates it. Evaluation
runs whole on every process; only rank 0 writes events and checkpoints.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from embodied_clip_tpu_torch.models.clip import _device
from embodied_clip_tpu_torch.models.probes import build_probe, probe_loss, probe_metrics
from embodied_clip_tpu_torch.parallel import mesh
from embodied_clip_tpu_torch.training.optim import Adam
from embodied_clip_tpu_torch.utils.checkpoint import BestCheckpointer
from embodied_clip_tpu_torch.utils.prefetch import prefetch_to_device, to_device
from embodied_clip_tpu_torch.utils.seeding import seed_everything
from embodied_clip_tpu_torch.utils.tensorboard import SummaryWriter

__all__ = ["ProbeTrainConfig", "ProbeTrainer", "probe_train_step"]


@dataclasses.dataclass
class ProbeTrainConfig:
    embedding_type: str = "clip_avgpool"
    prediction_type: str = "object_presence"
    lr: float = 1e-3          # train.py:137
    batch_size: int = 128     # train.py:136
    max_epochs: int = 250     # train.py:158
    val_per_epoch: int = 2    # val_check_interval=0.5, train.py:157
    seed: int = 1             # train.py:117
    log_dir: Optional[str] = None
    ckpt_dir: Optional[str] = None
    # Reading the loss on the host syncs the card; it is read every log_every steps
    # only (the reference logs per step because torch's eager loss is already there).
    log_every: int = 20
    # Data-parallel training over the processes of a torch.distributed group (the
    # reference's pl.Trainer(gpus=N), train.py:132-133,156).
    data_parallel: bool = False
    device: str = "cuda"


def probe_train_step(module: nn.Module, opt: Adam, prediction_type: str, x, y,
                     average: bool = False) -> torch.Tensor:
    """One Adam step of `module` (whose parameters are `opt.params`) on the batch
    (x, y), in place; with `average`, the gradients are averaged over the processes of
    the group first. Returns the batch loss (a 0-dim tensor on the device)."""
    loss = probe_loss(prediction_type, module(x), y)
    grads = list(torch.autograd.grad(loss, opt.params))
    if average:
        mesh.all_sum_(grads)
        torch._foreach_div_(grads, float(mesh.world_size()))
    opt.step(grads)
    return loss.detach()


class ProbeTrainer:
    def __init__(self, config: ProbeTrainConfig):
        self.cfg = config
        self.device = _device(config.device)
        if config.data_parallel and not torch.distributed.is_initialized():
            raise ValueError(
                "data_parallel=True runs one process per card in a torch.distributed "
                "group (parallel/distributed.initialize_distributed, or "
                "parallel/dryrun.run_ranks); none is initialized")
        self.module: Optional[nn.Module] = None
        self.opt: Optional[Adam] = None
        self.global_step = 0
        self.writer = None
        if config.log_dir and mesh.rank() == 0:
            # Reference logger layout: {log_dir}/{prediction_type}/{embedding_type}
            # (train.py:139-143).
            self.writer = SummaryWriter(
                os.path.join(config.log_dir, config.prediction_type, config.embedding_type)
            )
        self.best = BestCheckpointer(config.ckpt_dir if mesh.rank() == 0 else None)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The probe's live parameters by state_dict name (None before `init`)."""
        return None if self.module is None else self.module.state_dict()

    def _put_batch(self, batch):
        """(x, y, sharded): under data parallelism, this process's slice of a batch that
        divides evenly over the processes (sharded True); otherwise the whole batch."""
        x, y = batch
        n = len(x)
        sharded = self.cfg.data_parallel and n % mesh.world_size() == 0
        if sharded:
            sl = mesh.shard_batch(n)
            x = x[sl]
            y = tuple(v[sl] for v in y) if isinstance(y, tuple) else y[sl]
        x, y = to_device((x, y), self.device)
        return x, y, sharded

    # ------------------------------------------------------------------ lifecycle

    def init(self, example_x) -> None:
        """Draw the probe's weights from the config's seed (a CPU generator, so every
        device holds the same draw) for inputs shaped like `example_x`."""
        gen = seed_everything(self.cfg.seed, device="cpu")
        self.module = build_probe(self.cfg.embedding_type, self.cfg.prediction_type,
                                  in_features=example_x.shape[-1], generator=gen
                                  ).to(self.device)
        if self.cfg.data_parallel:
            mesh.replicate(self.module.parameters())
        self.opt = Adam(list(self.module.parameters()), self.cfg.lr)

    def load(self, path: str, example_x) -> None:
        """Restore probe params from a checkpoint (reference `-c ckpt` / eval flow): a
        `best.pt` of `BestCheckpointer`, or a file holding {"params": ...}."""
        from embodied_clip_tpu_torch.utils.checkpoint import restore_pytree

        if self.module is None:
            self.init(example_x)
        restored = restore_pytree(path)
        if isinstance(restored, dict) and "params" in restored:
            restored = restored["params"]
        self.module.load_state_dict(restored)

    def _log(self, tag: str, value: float) -> None:
        if self.writer:
            self.writer.add_scalar(tag, value, self.global_step)

    # ----------------------------------------------------------------- train loop

    def fit(self, dm) -> Dict[str, float]:
        if self.module is None:
            x0, _ = next(dm.batches("train", shuffle=False))
            self.init(x0)
        steps = dm.steps_per_epoch("train")
        val_every = max(1, steps // max(1, self.cfg.val_per_epoch))
        pt = self.cfg.prediction_type
        last_val: Dict[str, float] = {}
        for _epoch in range(self.cfg.max_epochs):
            batches = prefetch_to_device(dm.batches("train"), put=self._put_batch)
            for i, (x, y, sharded) in enumerate(batches):
                loss = probe_train_step(self.module, self.opt, pt, x, y, average=sharded)
                self.global_step += 1
                if self.cfg.log_dir and self.global_step % self.cfg.log_every == 0:
                    if sharded:  # the batch's loss: the mean of the equal shards'
                        loss = mesh.all_sum(loss) / mesh.world_size()
                    self._log("train_loss", float(loss))
                if (i + 1) % val_every == 0 or i + 1 == steps:
                    last_val = self.validate(dm)
        if self.writer:
            self.writer.flush()
        return last_val

    @torch.no_grad()
    def evaluate(self, dm, split: str) -> Dict[str, float]:
        """The split's loss and accuracy, each the unweighted mean over its batches (as
        PL logs epoch metrics), read on the host once."""
        pt = self.cfg.prediction_type
        losses: List[torch.Tensor] = []
        accs: List[torch.Tensor] = []
        for x, y in prefetch_to_device(dm.batches(split, shuffle=False), device=self.device):
            logits = self.module(x)
            losses.append(probe_loss(pt, logits, y))
            accs.append(probe_metrics(pt, logits, y)["accuracy"])
        n = len(losses)
        if not n:
            return {"loss": 0.0, "accuracy": 0.0}
        loss_l, acc_l = torch.stack([torch.stack(losses), torch.stack(accs)]).tolist()
        return {"loss": sum(loss_l) / n, "accuracy": sum(acc_l) / n}

    def validate(self, dm) -> Dict[str, float]:
        m = self.evaluate(dm, "val")
        self._log("val_loss", m["loss"])
        self._log("val_acc", m["accuracy"])
        self.best.update(m["loss"], self.params, tag=f"step{self.global_step}")
        return m

    def test(self, dm, use_best: bool = True) -> Dict[str, float]:
        """Evaluate on test with the best-val params (reference ckpt_path='best',
        train.py:170-174)."""
        saved = None
        if use_best and self.best.best_params is not None:
            saved = {k: v.clone() for k, v in self.params.items()}
            self.module.load_state_dict(self.best.best_params)
        m = self.evaluate(dm, "test")
        self._log("test_loss", m["loss"])
        self._log("test_acc", m["accuracy"])
        if saved is not None:
            self.module.load_state_dict(saved)
        if self.writer:
            self.writer.flush()
        return m
