"""The DD-PPO optimizer: optax's `chain(clip_by_global_norm(max_norm), adam(lr))` with
its optional `linear_schedule(lr, 0, decay_updates)` (`embodied_clip_tpu/training/
ddppo.py:86-94`), in optax's formulas:

  clip   g ← g                      if ‖g‖ < max_norm
         g ← (g / ‖g‖) · max_norm    otherwise (‖g‖ over every parameter at once)
  adam   μ ← (1−β1)·g + β1·μ,  ν ← (1−β2)·g² + β2·ν,  n ← n + 1
         u = (μ / (1 − β1ⁿ)) / (sqrt(ν / (1 − β2ⁿ)) + ε)       (eps_root = 0)
  lr     p ← p − lr(n − 1)·u, the schedule read at the count before this update:
         lr(c) = lr · (1 − min(c, N) / N) with N = decay_updates, else lr.

`torch.nn.utils.clip_grad_norm_` adds 1e-6 to the norm and `torch.optim.Adam` puts ε
elsewhere in the bias correction, so neither is used.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch

__all__ = ["ClippedAdam"]


class ClippedAdam:
    """Global-norm clipping, then Adam, over a fixed list of parameters; the moments
    and the update count live here."""

    b1, b2, eps = 0.9, 0.999, 1e-8  # optax.adam's defaults, which the JAX learner uses

    def __init__(self, params: Iterable[torch.Tensor], lr: float, max_grad_norm: float,
                 decay_updates: int = 0):
        self.params: List[torch.Tensor] = list(params)
        self.lr, self.max_grad_norm, self.decay_updates = lr, max_grad_norm, decay_updates
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def learning_rate(self) -> float:
        """The rate of the next update (optax reads the count before incrementing)."""
        if self.decay_updates <= 0:
            return self.lr
        return self.lr * (1.0 - min(self.count, self.decay_updates) / self.decay_updates)

    @torch.no_grad()
    def step(self, grads: Optional[List[torch.Tensor]] = None) -> None:
        """One update from `grads` (the parameters' `.grad` if None), in place."""
        if grads is None:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < self.max_grad_norm, 1.0, self.max_grad_norm / norm)
        g = torch._foreach_mul(grads, scale)
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
