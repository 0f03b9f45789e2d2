"""ResNet-18/50 encoder over an N-channel proxy representation.

Counterpart of ``soccerplayershapepose_tpu/models/resnet.py`` in NCHW:
conv7×7/2 (padding 3) → BN → ReLU → max-pool 3/2 (padding 1) → four stages
→ global average pool, giving a 512-d (ResNet-18) or 2048-d (ResNet-50)
feature. Every 3×3 convolution pads 1 on each side, as the JAX modules'
explicit ``padding=[(1, 1), (1, 1)]`` does; the 1×1 projections pad nothing.
Batch norm uses eps 1e-5 (flax momentum 0.9 is PyTorch momentum 0.1). In
train mode its running variance takes the biased batch variance, as flax's
does (:class:`BatchNorm2d`); eval mode is ``nn.BatchNorm2d``'s own.
Inside ``parallel.collectives.data_parallel`` a train-mode batch norm
normalises by the data group's global batch, as the JAX package's batch
norm does under a sharded ``jit``.

Each block keeps its convolutions and norms in two lists in the flax
modules' order (``Conv_0``, ``Conv_1``, … then the projection), so the
weight converter (``convert.regressor_state_dict_from_flat``) maps flax
names onto these by index.
"""

from __future__ import annotations

from typing import Sequence, Type

import torch
from torch import nn
from torch.nn import functional as F

from soccerplayershapepose_torch.parallel.collectives import (
    current_data_group, global_batch_norm)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's train-mode update of the running
    statistics: ``running ← 0.9·running + 0.1·batch`` with the BIASED batch
    variance (PyTorch's own update takes the unbiased one, n/(n−1) larger,
    14% at 2 rows of an 8 × 8 map). The batch is normalised by its biased
    variance either way; eval mode is unchanged. ``num_batches_tracked``
    stays 0, as flax keeps no such count (the momentum is fixed). Inside
    ``data_parallel(group)`` the batch is the group's global batch
    (``parallel/collectives.py:GlobalBatchNorm``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        group = current_data_group()
        if group is not None:
            return global_batch_norm(self, x, group)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(1.0 - self.momentum).add_(
                mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(
                var, alpha=self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


def _norm(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=1e-5, momentum=0.1)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        convs = [_conv(cin, features, 3, stride), _conv(features, features, 3)]
        if downsample:
            convs.append(_conv(cin, features, 1, stride))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(_norm(features) for _ in convs)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norms[0](self.convs[0](x)))
        y = self.norms[1](self.convs[1](y))
        r = self.norms[2](self.convs[2](x)) if self.downsample else x
        return F.relu(y + r)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = features * self.expansion
        convs = [_conv(cin, features, 1), _conv(features, features, 3, stride),
                 _conv(features, out, 1)]
        if downsample:
            convs.append(_conv(cin, out, 1, stride))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(
            _norm(c.out_channels) for c in convs)
        self.downsample = downsample

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norms[0](self.convs[0](x)))
        y = F.relu(self.norms[1](self.convs[1](y)))
        y = self.norms[2](self.convs[2](y))
        r = self.norms[3](self.convs[3](x)) if self.downsample else x
        return F.relu(y + r)


class ResNet(nn.Module):
    """(B, C, H, W) → (B, out_features) pooled feature (no classifier)."""

    def __init__(self, block: Type[nn.Module], stage_sizes: Sequence[int],
                 in_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, 64, 7, stride=2, padding=3,
                              bias=False)
        self.norm = _norm(64)
        blocks, cin = [], 64
        for stage, n_blocks in enumerate(stage_sizes):
            features = 64 * 2 ** stage
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                out = features * block.expansion
                blocks.append(block(cin, features, stride,
                                    stride != 1 or (i == 0 and cin != out)))
                cin = out
        self.blocks = nn.ModuleList(blocks)
        self.out_features = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm(self.conv(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for blk in self.blocks:
            x = blk(x)
        return x.mean(dim=(2, 3))


def resnet18(in_channels: int) -> ResNet:
    return ResNet(BasicBlock, (2, 2, 2, 2), in_channels)


def resnet50(in_channels: int) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), in_channels)
