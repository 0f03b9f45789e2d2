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

Training (:func:`center_targets`, :func:`detector_loss`) splats a
Gaussian at each ground-truth box's centre cell and takes the CenterNet
focal loss on the heatmap plus L1 losses of the size and offset gathered
at those cells; boxes whose centre lies off the frame are masked.

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
from soccerplayershapepose_torch.parallel.collectives import data_sum

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


def center_targets(boxes: torch.Tensor, mask: torch.Tensor,
                   hw, stride: int = STRIDE) -> dict:
    """Training maps from (B, N, 4) pixel boxes and their (B, N) validity.

    Returns ``heat`` (B, h, w), the max over boxes of a Gaussian at each
    centre cell (radius a third of the box's smaller side in cells,
    clipped to [1, 8], σ = radius / 1.5); ``size`` and ``offset`` (B, N,
    2), the box's (w, h) in cells and its centre's place in the cell minus
    0.5; ``cell`` (B, N) int64 flat centre-cell indices; ``mask`` (B, N),
    the validity with boxes whose centre lies off the frame dropped.
    """
    h, w = hw[0] // stride, hw[1] // stride
    cx = (boxes[..., 0] + boxes[..., 2]) / 2 / stride
    cy = (boxes[..., 1] + boxes[..., 3]) / 2 / stride
    bw = (boxes[..., 2] - boxes[..., 0]) / stride
    bh = (boxes[..., 3] - boxes[..., 1]) / stride
    inside = ((cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)).to(torch.float32)
    mask = mask * inside
    ix = torch.clamp(torch.floor(cx), 0, w - 1)
    iy = torch.clamp(torch.floor(cy), 0, h - 1)
    radius = torch.clamp(torch.minimum(bw, bh) / 3.0, 1.0, 8.0)
    ys = torch.arange(h, dtype=torch.float32, device=boxes.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=boxes.device)[None, :]
    d2 = ((ys - iy[..., None, None]) ** 2
          + (xs - ix[..., None, None]) ** 2)                  # (B, N, h, w)
    g = torch.exp(-d2 / (2.0 * (radius[..., None, None] / 1.5) ** 2))
    heat = torch.amax(g * mask[..., None, None], dim=1)
    return {"heat": heat, "size": torch.stack([bw, bh], dim=-1),
            "offset": torch.stack([cx - ix - 0.5, cy - iy - 0.5], dim=-1),
            "cell": (iy * w + ix).to(torch.int64), "mask": mask}


def detector_loss(out: DetectorOutput, targets: dict, mask: torch.Tensor):
    """CenterNet focal loss on the heatmap (positives where the target is
    ≥ 0.999, normalised by their count) + 0.1 · L1 of the size + L1 of the
    offset at the ground-truth cells, both over the valid boxes. Returns
    ``(total, {"heat", "size", "offset"})``; inside
    ``parallel.collectives.data_parallel`` both counts are the global
    batch's, so each term is the rank's share of the global one."""
    mask = mask * targets["mask"]
    b, h, w, _ = out.center_logits.shape
    heat_t = targets["heat"]
    p = torch.sigmoid(out.center_logits[..., 0])
    pos = (heat_t >= 0.999).to(torch.float32)
    eps = 1e-6
    pos_loss = -torch.log(p + eps) * (1 - p) ** 2 * pos
    neg_loss = -torch.log(1 - p + eps) * p ** 2 * (1 - heat_t) ** 4 \
        * (1.0 - pos)
    n_pos = torch.clamp(data_sum(torch.sum(pos)), min=1.0)
    heat_loss = (torch.sum(pos_loss) + torch.sum(neg_loss)) / n_pos

    def take(t):
        flat = t.reshape(b, h * w, t.shape[-1])
        return torch.gather(flat, 1, targets["cell"][..., None].expand(
            -1, -1, t.shape[-1]))

    m = mask[..., None]
    n = torch.clamp(data_sum(torch.sum(mask)), min=1.0)
    size_loss = torch.sum(torch.abs(take(out.size) - targets["size"]) * m) / n
    off_loss = torch.sum(torch.abs(take(out.offset) - targets["offset"])
                         * m) / n
    total = heat_loss + 0.1 * size_loss + off_loss
    return total, {"heat": heat_loss, "size": size_loss, "offset": off_loss}
