"""ResNet feature pyramid: the trunk of the perception nets.

Counterpart of ``soccerplayershapepose_tpu/models/backbone.py`` in NCHW.
:class:`ResNetFeatures` is ``models/resnet.py:ResNet`` without the final
pooling: the same stem (conv 7×7/2, padding 3 → BN → ReLU → max-pool 3/2,
padding 1) and blocks, returning the four stage maps C2..C5 at strides 4,
8, 16 and 32. :class:`FPN` adds 1×1 lateral projections with bias, a
nearest-2× top-down sum and 3×3 smoothing (padding 1), one
``channels``-wide map per level, fine to coarse.

Module names follow the flax modules' so that the weight converter
(``convert.proxynet_state_dict_from_flat``) maps them by index:
``conv``/``norm`` are the stem's ``Conv_0``/``BatchNorm_0``, ``blocks.k``
is ``BasicBlock_k`` (or ``Bottleneck_k``), ``lateral.i`` and ``smooth.i``
are ``lateral{i}`` and ``smooth{i}``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Type

import torch
from torch import nn
from torch.nn import functional as F

from soccerplayershapepose_torch.models.resnet import (
    BasicBlock, Bottleneck, _norm)


class ResNetFeatures(nn.Module):
    """(B, C, H, W) → [C2 (/4), C3 (/8), C4 (/16), C5 (/32)]."""

    def __init__(self, block: Type[nn.Module], stage_sizes: Sequence[int],
                 in_channels: int = 3, width: int = 64):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, width, 7, stride=2, padding=3,
                              bias=False)
        self.norm = _norm(width)
        blocks, ends, cin = [], [], width
        for stage, n_blocks in enumerate(stage_sizes):
            features = width * 2 ** stage
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                out = features * block.expansion
                blocks.append(block(cin, features, stride,
                                    stride != 1 or (i == 0 and cin != out)))
                cin = out
            ends.append(len(blocks))
        self.blocks = nn.ModuleList(blocks)
        self.stage_ends = tuple(ends)
        self.out_channels = tuple(
            width * 2 ** s * block.expansion for s in range(len(stage_sizes)))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.norm(self.conv(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        feats = []
        for k, blk in enumerate(self.blocks):
            x = blk(x)
            if k + 1 in self.stage_ends:
                feats.append(x)
        return feats


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2× upsampling of the last two axes (H, W of NCHW)."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


class FPN(nn.Module):
    """Top-down pyramid: laterals, nearest-2× sums, 3×3 smoothing."""

    def __init__(self, in_channels: Sequence[int], channels: int = 128):
        super().__init__()
        self.lateral = nn.ModuleList(
            nn.Conv2d(c, channels, 1) for c in in_channels)
        self.smooth = nn.ModuleList(
            nn.Conv2d(channels, channels, 3, padding=1) for _ in in_channels)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        laterals = [conv(f) for conv, f in zip(self.lateral, feats)]
        outs = [laterals[-1]]
        for lat in laterals[-2::-1]:
            outs.append(lat + upsample2x(outs[-1]))
        outs = outs[::-1]                       # back to fine → coarse
        return [conv(o) for conv, o in zip(self.smooth, outs)]


class FPNTrunk(nn.Module):
    """Trunk + FPN: the stride-4 map P2 (the heads' resolution) and the
    whole pyramid."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 block: Type[nn.Module] = BasicBlock, channels: int = 128,
                 width: int = 64, in_channels: int = 3):
        super().__init__()
        self.trunk = ResNetFeatures(block, stage_sizes, in_channels, width)
        self.fpn = FPN(self.trunk.out_channels, channels)
        self.channels = channels

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        pyramid = self.fpn(self.trunk(x))
        return pyramid[0], pyramid


def fpn_trunk_r18(channels: int = 128, width: int = 64) -> FPNTrunk:
    return FPNTrunk((2, 2, 2, 2), BasicBlock, channels, width)


def fpn_trunk_r50(channels: int = 256, width: int = 64) -> FPNTrunk:
    return FPNTrunk((3, 4, 6, 3), Bottleneck, channels, width)
