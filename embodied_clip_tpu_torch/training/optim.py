"""The port's optimizers in optax's formulas: `Adam`, optax's `adam(lr)` (the probe
trainer's, `embodied_clip_tpu/training/supervised.py:63`), and `ClippedAdam`, the DD-PPO
optimizer, optax's `chain(clip_by_global_norm(max_norm), adam(lr))` with its optional
`linear_schedule(lr, 0, decay_updates)` (`embodied_clip_tpu/training/ddppo.py:86-94`):

  clip   g ← g                      if ‖g‖ < max_norm
         g ← (g / ‖g‖) · max_norm    otherwise (‖g‖ over every parameter at once)
  adam   μ ← (1−β1)·g + β1·μ,  ν ← (1−β2)·g² + β2·ν,  n ← n + 1
         u = (μ / (1 − β1ⁿ)) / (sqrt(ν / (1 − β2ⁿ)) + ε)       (eps_root = 0)
  lr     p ← p − lr(n − 1)·u, the schedule read at the count before this update:
         lr(c) = lr · (1 − min(c, N) / N) with N = decay_updates, else lr.

`torch.nn.utils.clip_grad_norm_` adds 1e-6 to the norm and `torch.optim.Adam` puts ε
elsewhere in the bias correction, so neither is used.

`state_dict()` holds what optax's state holds: the update count (the schedule's
position and the bias correction's n) and the moments μ and ν, in parameter order, so
that a resumed run takes the updates an uninterrupted one would.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import torch

__all__ = ["Adam", "ClippedAdam"]


class Adam:
    """Adam over a fixed list of parameters, updated in place; the moments and the
    update count live here."""

    b1, b2, eps = 0.9, 0.999, 1e-8  # optax.adam's defaults, which the JAX learners use

    def __init__(self, params: Iterable[torch.Tensor], lr: float, decay_updates: int = 0):
        self.params: List[torch.Tensor] = list(params)
        self.lr, self.decay_updates = lr, decay_updates
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def state_dict(self) -> Dict[str, Any]:
        """{"count": 0-dim int64 tensor, "mu": [tensors], "nu": [tensors]}, the moments
        in the order of the parameters (copies)."""
        return {"count": torch.tensor(self.count, dtype=torch.int64),
                "mu": [m.detach().clone() for m in self.mu],
                "nu": [v.detach().clone() for v in self.nu]}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore `state_dict()`'s output (moments copied onto the parameters'
        devices, in place)."""
        if len(state["mu"]) != len(self.mu) or len(state["nu"]) != len(self.nu):
            raise ValueError(f"optimizer state holds {len(state['mu'])} moments, this "
                             f"optimizer has {len(self.mu)} parameters")
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            if dst.shape != src.shape:
                raise ValueError(f"optimizer moment of shape {tuple(src.shape)}, "
                                 f"expected {tuple(dst.shape)}")
            dst.copy_(src)
        self.count = int(state["count"])

    def learning_rate(self) -> float:
        """The rate of the next update (optax reads the count before incrementing)."""
        if self.decay_updates <= 0:
            return self.lr
        return self.lr * (1.0 - min(self.count, self.decay_updates) / self.decay_updates)

    def _grads(self, grads: Optional[List[torch.Tensor]]) -> List[torch.Tensor]:
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
        return list(grads)

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None) -> None:
        """One update from `grads` (the parameters' `.grad` if None), in place."""
        self._adam(self._grads(grads))

    def _adam(self, g: List[torch.Tensor]) -> None:
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - self.b2)
        lr = self.learning_rate()
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(self.params, upd, alpha=-lr)


class ClippedAdam(Adam):
    """Global-norm clipping, then Adam."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float, max_grad_norm: float,
                 decay_updates: int = 0):
        super().__init__(params, lr, decay_updates)
        self.max_grad_norm = max_grad_norm

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None) -> None:
        """One update from `grads` (the parameters' `.grad` if None), in place."""
        grads = self._grads(grads)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < self.max_grad_norm, 1.0, self.max_grad_norm / norm)
        self._adam(torch._foreach_mul(grads, scale))
