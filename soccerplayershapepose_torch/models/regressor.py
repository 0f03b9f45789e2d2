"""Encoder + IEF regressor: proxy representation → SMPL parameters.

Counterpart of ``soccerplayershapepose_tpu/models/regressor.py``, taking
the proxy in NCHW: ResNet-18 (512-d) or ResNet-50 (2048-d) over 18, 20 or
21 channels, then the IEF head giving the weak-perspective camera (3), the
24·6D pose (144) and the shape (10).
"""

from __future__ import annotations

import torch
from torch import nn

from soccerplayershapepose_torch.models.ief import IEFModule
from soccerplayershapepose_torch.models.resnet import resnet18, resnet50


class SingleInputRegressor(nn.Module):
    def __init__(self, in_channels: int = 18, resnet_layers: int = 18,
                 ief_iters: int = 3):
        super().__init__()
        if resnet_layers == 18:
            self.encoder = resnet18(in_channels)
            self.ief = IEFModule((512, 512), 512, ief_iters)
        elif resnet_layers == 50:
            self.encoder = resnet50(in_channels)
            self.ief = IEFModule((1024, 1024), 2048, ief_iters)
        else:
            raise ValueError(
                f"resnet_layers must be 18 or 50, got {resnet_layers}")
        self.in_channels = in_channels
        self.resnet_layers = resnet_layers

    def forward(self, proxy_rep: torch.Tensor, initial_params: torch.Tensor):
        """(B, in_channels, wh, wh), (157,) → (cam (B, 3), pose (B, 144),
        shape (B, 10))."""
        if proxy_rep.dim() != 4 or proxy_rep.shape[1] != self.in_channels:
            raise ValueError(f"expected (B, {self.in_channels}, H, W) proxy, "
                             f"got {tuple(proxy_rep.shape)}")
        return self.ief(self.encoder(proxy_rep), initial_params)
