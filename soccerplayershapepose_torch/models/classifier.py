"""Main-camera frame classifier head.

Counterpart of ``soccerplayershapepose_tpu/models/classifier.py``: a
2-layer MLP (1000 → 500 → 2) over the 1000 logits of a frozen ResNet-18
(``pipeline/classification.py:FrameFeatureNet``), deciding whether a video
frame is a main-camera (wide) shot. The flax ``Dense_k`` layers are
``fcs[k]`` here (``convert.classifier_state_dict_from_flat``).
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class ClassifyNet(nn.Module):
    def __init__(self, in_features: int = 1000, hidden: int = 500,
                 num_classes: int = 2):
        super().__init__()
        self.fcs = nn.ModuleList([nn.Linear(in_features, hidden),
                                  nn.Linear(hidden, num_classes)])

    def forward(self, backbone_logits: torch.Tensor) -> torch.Tensor:
        """(B, 1000) frozen-backbone logits → (B, 2) class logits."""
        return self.fcs[1](F.relu(self.fcs[0](backbone_logits)))
