"""Adam as ``optax.adam`` computes it, with an explicit schedule.

``optax.adam(lr)`` is ``scale_by_adam`` (β1 0.9, β2 0.999, ε 1e-8 added
outside the square root) followed by ``-lr``. With a schedule, ``lr`` is
evaluated at the optimizer's step count BEFORE the step increments it, so
the first update uses ``lr(0)``. Writing the optimizer out keeps that rule
in one place (a ``torch.optim.lr_scheduler`` stepped once too early or too
late would shift the whole curve by one step) and gives its state plain
names for checkpoints: ``mu`` and ``nu`` (the first and second moments, one
tensor per parameter, in the parameters' order) and ``count``.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Union

import torch

Schedule = Union[float, Callable[[int], float]]


class Adam:
    """Adam over ``params`` (leaf tensors with ``requires_grad``)."""

    def __init__(self, params: Sequence[torch.Tensor], lr: Schedule,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params: List[torch.Tensor] = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def learning_rate(self) -> float:
        """The rate of the next update."""
        return float(self.lr(self.count)) if callable(self.lr) else self.lr

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad`` (None counts as 0)."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        lr = self.learning_rate()
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        self.count += 1
        mu_hat = torch._foreach_div(self.mu, 1.0 - self.b1 ** self.count)
        nu_hat = torch._foreach_div(self.nu, 1.0 - self.b2 ** self.count)
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, self.eps)
        torch._foreach_div_(mu_hat, nu_hat)
        torch._foreach_mul_(mu_hat, lr)
        torch._foreach_sub_(self.params, mu_hat)
