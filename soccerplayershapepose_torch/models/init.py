"""flax's default initialisers for the port's modules.

A flax module trained from scratch starts from ``lecun_normal`` kernels (a
normal of standard deviation √(1/fan_in) / 0.8796…, truncated at ±2 of its
own standard deviations), zero biases, batch norm scale 1 and bias 0 with
running mean 0 and variance 1. PyTorch's layers start from other
distributions, so the port's trainers re-draw every layer this way from an
explicit ``torch.Generator`` before training from scratch. The draws are
flax's distributions, not its numbers: a test that needs both packages to
start from the same point carries the JAX variables across
(``convert.train_state_from_jax``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

# Standard deviation of a unit normal truncated at ±2, which
# ``lecun_normal`` divides by so the truncated draw keeps variance 1/fan_in.
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  gen: torch.Generator) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    draw = torch.empty(weight.shape, dtype=torch.float32)
    nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=gen)
    return weight.copy_(draw)


@torch.no_grad()
def flax_init_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Re-draw every ``Conv2d`` and ``Linear`` weight of ``module`` with
    ``lecun_normal`` (fan-in: in_channels·kh·kw, or in_features), zero
    their biases and reset every batch norm to scale 1, bias 0, mean 0,
    variance 1. The draws come from ``gen`` (a CPU generator) in the
    order of ``module.modules()``."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, m.in_channels * m.kernel_size[0]
                          * m.kernel_size[1], gen)
        elif isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, gen)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
            continue
        else:
            continue
        if m.bias is not None:
            m.bias.zero_()
    return module
