"""Adam as ``optax.adam`` computes it, with an explicit schedule.

``optax.adam(lr)`` is ``scale_by_adam`` (β1 0.9, β2 0.999, ε 1e-8 added
outside the square root) followed by ``-lr``. With a schedule, ``lr`` is
evaluated at the optimizer's step count BEFORE the step increments it, so
the first update uses ``lr(0)``. Writing the optimizer out keeps that rule
in one place (a ``torch.optim.lr_scheduler`` stepped once too early or too
late would shift the whole curve by one step) and gives its state plain
names for checkpoints: ``mu`` and ``nu`` (the first and second moments, one
tensor per parameter, in the parameters' order) and ``count``.

:func:`warmup_cosine_decay` is ``optax.warmup_cosine_decay_schedule``, the
schedule of the relation trainer and of the perception and regressor
training drivers (``scripts/train_perception_torch.py``).
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Union

import torch

Schedule = Union[float, Callable[[int], float]]


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule`` as a plain function of the
    step count: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine from ``peak_value`` to ``end_value``
    over the remaining ``decay_steps − warmup_steps``, then flat."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(float(count - warmup_steps), float(span))
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / span))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


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
