"""PlayerDetector: an anchor-free single-stage person detector.

Counterpart of ``soccerplayershapepose_tpu/models/detector.py``: an R18-FPN
trunk (``models/backbone.py``) fed ``images · 2 − 1``, a two-conv tower
(``ConvTower``) on its stride-4 map P2 and three 1×1 heads: the centre
heatmap logit, the box size (w, h) in cells through a softplus, and the
sub-cell offset (dx, dy). The module takes NCHW images; its outputs are
permuted once into the JAX package's channels-last layout.

:func:`decode_detections` turns the maps into a static top-K of scored
boxes: a 3×3 max-pool peak test, the K best peaks, and greedy box NMS
(``ops/nms.py``) that zeroes the scores of suppressed boxes. Its top-K is
a stable descending sort, so that among equal scores (most of the K slots
hold zero-score non-peaks) the lower cell index comes first, as
``jax.lax.top_k`` orders them; ``torch.topk`` gives no such order.

``F.softplus`` returns its input above 20 where ``jax.nn.softplus``
computes log(1 + eˣ): the two differ there by less than 2e-9 cells.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.nn import functional as F

from soccerplayershapepose_torch.models.backbone import (
    FPNTrunk, fpn_trunk_r18)
from soccerplayershapepose_torch.models.perception import (
    ConvTower, _channels_last)
from soccerplayershapepose_torch.ops.nms import nms

STRIDE = 4


class DetectorOutput(NamedTuple):
    center_logits: torch.Tensor   # (B, H/4, W/4, 1)
    size: torch.Tensor            # (B, H/4, W/4, 2) box (w, h) / stride
    offset: torch.Tensor          # (B, H/4, W/4, 2) sub-cell (dx, dy)


class Detections(NamedTuple):
    boxes: torch.Tensor           # (B, K, 4) [x1, y1, x2, y2] pixels
    scores: torch.Tensor          # (B, K) descending before the box NMS


class PlayerDetector(nn.Module):
    """Centre-point detector on an FPN trunk."""

    def __init__(self, channels: int = 128, trunk: Optional[FPNTrunk] = None):
        super().__init__()
        self.channels = channels
        self.trunk = trunk if trunk is not None else fpn_trunk_r18(channels)
        self.det_tower = ConvTower(channels)
        self.center_out = nn.Conv2d(channels, 1, 1)
        self.size_out = nn.Conv2d(channels, 2, 1)
        self.offset_out = nn.Conv2d(channels, 2, 1)

    def forward(self, images: torch.Tensor) -> DetectorOutput:
        """images: (B, 3, H, W) float in [0, 1]; H, W divisible by 32."""
        p2, _ = self.trunk(images * 2.0 - 1.0)
        tower = self.det_tower(p2)
        return DetectorOutput(
            _channels_last(self.center_out(tower)),
            F.softplus(_channels_last(self.size_out(tower))),
            _channels_last(self.offset_out(tower)))


def apply_flip_tta(model: PlayerDetector,
                   images: torch.Tensor) -> DetectorOutput:
    """Horizontal-flip ensemble: one forward at 2B (the images, then their
    mirrors), the mirrored half's maps flipped back along W and averaged
    with the plain half. A mirrored centre at cell w − 1 − px has offset
    −dx; dy and the size are mirror-invariant, so merging flips W and
    negates the dx channel. ``images`` (B, 3, H, W)."""
    out = model(torch.cat([images, images.flip(3)], 0))
    b = images.shape[0]
    center = 0.5 * (out.center_logits[:b] + out.center_logits[b:].flip(2))
    size = 0.5 * (out.size[:b] + out.size[b:].flip(2))
    sign = torch.tensor([-1.0, 1.0], dtype=out.offset.dtype,
                        device=out.offset.device)
    offset = 0.5 * (out.offset[:b] + out.offset[b:].flip(2) * sign)
    return DetectorOutput(center, size, offset)


def decode_detections(out: DetectorOutput, top_k: int = 48,
                      stride: int = STRIDE,
                      box_nms_iou: Optional[float] = 0.7) -> Detections:
    """Peak test + static top-K → pixel-space scored boxes (B, K).

    A cell is a peak where its sigmoid score equals the 3×3 maximum around
    it (the border padded with −inf); other cells score 0. The K best
    cells, ties to the lower index, give boxes from their size and offset
    (clipped to [−1, 2]). With ``box_nms_iou`` greedy box NMS over the K
    boxes zeroes the score of each box it suppresses (one body firing two
    peaks ≥ 2 cells apart); None disables it.
    """
    b, h, w, _ = out.center_logits.shape
    heat = torch.sigmoid(out.center_logits[..., 0])           # (B, h, w)
    pooled = F.max_pool2d(heat[:, None], 3, stride=1, padding=1)[:, 0]
    peaks = torch.where(heat >= pooled, heat, 0.0).reshape(b, h * w)
    scores, idx = torch.sort(peaks, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :top_k], idx[:, :top_k]           # (B, K)
    py = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
    px = (idx % w).to(torch.float32)

    def take(t):
        flat = t.reshape(b, h * w, t.shape[-1])
        return torch.gather(flat, 1, idx[..., None].expand(-1, -1,
                                                           t.shape[-1]))

    wh = take(out.size) * stride                              # (B, K, 2) px
    off = torch.clamp(take(out.offset), -1.0, 2.0)
    cx = (px + 0.5 + off[..., 0]) * stride
    cy = (py + 0.5 + off[..., 1]) * stride
    boxes = torch.stack([cx - wh[..., 0] / 2, cy - wh[..., 1] / 2,
                         cx + wh[..., 0] / 2, cy + wh[..., 1] / 2], dim=-1)
    if box_nms_iou is not None:
        keep, valid = nms(boxes, scores, box_nms_iou)
        # Invalid slots carry index 0 and valid False: a sum of the valid
        # flags at each index, not an overwrite, so they cannot clear slot 0.
        kept = torch.zeros_like(idx).scatter_add_(1, keep,
                                                  valid.to(idx.dtype)) > 0
        scores = torch.where(kept, scores, 0.0)
    return Detections(boxes=boxes, scores=scores)
