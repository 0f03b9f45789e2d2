"""Iterative Error Feedback (IEF) head: features → SMPL parameters.

Counterpart of ``soccerplayershapepose_tpu/models/ief.py``. From the mean
parameters (camera scale 0.9, the mean 6D pose, the mean shape) three
iterations of ``fc(features ‖ params) → ReLU → fc → ReLU → fc`` add a delta
each; the three Linear layers are shared across the iterations.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from soccerplayershapepose_torch import config as cfg

NUM_CAM_PARAMS = 3
NUM_POSE_PARAMS = cfg.NUM_JOINTS * 6
NUM_SHAPE_PARAMS = cfg.NUM_BETAS
NUM_OUTPUT_PARAMS = NUM_CAM_PARAMS + NUM_POSE_PARAMS + NUM_SHAPE_PARAMS


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
