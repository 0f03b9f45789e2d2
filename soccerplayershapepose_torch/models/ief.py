"""Iterative Error Feedback (IEF) head: features → SMPL parameters.

Counterpart of ``soccerplayershapepose_tpu/models/ief.py``. From the mean
parameters (camera scale 0.9, the mean 6D pose, the mean shape) three
iterations of ``fc(features ‖ params) → ReLU → fc → ReLU → fc`` add a delta
each; the three Linear layers are shared across the iterations.

On a (data, model) grid (``parallel/mesh.py``) the large fc layers are
column-parallel (:meth:`IEFModule.shard_columns`), by the rule of the JAX
package's dry run (``__graft_entry__.py:param_spec``): a 2-D dense kernel
of at least 64K elements whose output dimension divides by the model axis
is split on that dimension, so each rank of a model row holds a slice of
its outputs (``nn.Linear.weight``'s rows); its bias stays whole. At
ResNet-18 widths 669 → 512 and 512 → 512 split; 512 → 157 does not (157 is
odd).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.parallel.collectives import (
    copy_to_group, gather_columns)

NUM_CAM_PARAMS = 3
NUM_POSE_PARAMS = cfg.NUM_JOINTS * 6
NUM_SHAPE_PARAMS = cfg.NUM_BETAS
NUM_OUTPUT_PARAMS = NUM_CAM_PARAMS + NUM_POSE_PARAMS + NUM_SHAPE_PARAMS
# The smallest dense kernel split over the model axis (the JAX dry run's).
MIN_SPLIT_ELEMENTS = 64 * 1024


def splits_on_model_axis(shape, n_model: int) -> bool:
    """Whether a weight of ``shape`` (torch layout, output first) splits
    over a model axis of ``n_model``: 2-D, at least MIN_SPLIT_ELEMENTS
    elements, its output dimension a multiple of ``n_model``."""
    return (n_model > 1 and len(shape) == 2
            and shape[0] * shape[1] >= MIN_SPLIT_ELEMENTS
            and shape[0] % n_model == 0)


class ColumnParallelLinear(nn.Module):
    """Rank ``index`` of ``n_model``'s part of a dense layer: rows
    [index·k, (index+1)·k) of the full weight, k = out / n_model, and the
    whole bias. The input's gradient is summed over ``group`` (each part
    gives its share), the outputs are gathered over it, then the bias
    added; ``weight`` and ``bias`` keep ``nn.Linear``'s names."""

    def __init__(self, full: nn.Linear, group, n_model: int, index: int):
        super().__init__()
        k = full.out_features // n_model
        self.in_features, self.out_features = full.in_features, \
            full.out_features
        self.weight = nn.Parameter(
            full.weight.detach()[index * k:(index + 1) * k].clone())
        self.bias = nn.Parameter(full.bias.detach().clone())
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(copy_to_group(x, self.group), self.weight)
        return gather_columns(y, self.group) + self.bias


def default_initial_params(mean_pose_rot6d: torch.Tensor,
                           mean_shape: torch.Tensor) -> torch.Tensor:
    """(157,) [cam s=0.9, tx=0, ty=0 | mean 6D pose | mean shape]."""
    cam = torch.tensor([0.9, 0.0, 0.0], dtype=torch.float32,
                       device=mean_shape.device)
    return torch.cat([cam, mean_pose_rot6d, mean_shape])


class IEFModule(nn.Module):
    def __init__(self, hidden: Sequence[int] = (512, 512),
                 in_features: int = 512, iterations: int = 3):
        super().__init__()
        self.fcs = nn.ModuleList([
            nn.Linear(in_features + NUM_OUTPUT_PARAMS, hidden[0]),
            nn.Linear(hidden[0], hidden[1]),
            nn.Linear(hidden[1], NUM_OUTPUT_PARAMS)])
        for fc in self.fcs:            # zero biases, as the JAX module
            nn.init.zeros_(fc.bias)
        self.iterations = iterations

    def shard_columns(self, group, n_model: int, index: int) -> list:
        """Make each fc layer that :func:`splits_on_model_axis` a
        :class:`ColumnParallelLinear` of rank ``index`` of ``n_model``
        over ``group``, in place. Returns the indices split."""
        split = []
        for i, fc in enumerate(self.fcs):
            if isinstance(fc, nn.Linear) and splits_on_model_axis(
                    tuple(fc.weight.shape), n_model):
                self.fcs[i] = ColumnParallelLinear(fc, group, n_model, index)
                split.append(i)
        return split

    def forward(self, features: torch.Tensor, initial_params: torch.Tensor):
        """(B, in_features), (157,) → cam (B, 3), pose (B, 144),
        shape (B, 10)."""
        params = initial_params.expand(features.shape[0], NUM_OUTPUT_PARAMS)
        for _ in range(self.iterations):
            h = F.relu(self.fcs[0](torch.cat([features, params], dim=1)))
            h = F.relu(self.fcs[1](h))
            params = params + self.fcs[2](h)
        cam = params[:, :NUM_CAM_PARAMS]
        pose = params[:, NUM_CAM_PARAMS:NUM_CAM_PARAMS + NUM_POSE_PARAMS]
        shape = params[:, NUM_CAM_PARAMS + NUM_POSE_PARAMS:]
        return cam, pose, shape
