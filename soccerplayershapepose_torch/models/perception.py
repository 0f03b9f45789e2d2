"""ProxyNet: keypoints, silhouette and IUV from an RGB player crop.

Counterpart of ``soccerplayershapepose_tpu/models/perception.py``. One
fully-convolutional net over the whole crop: an R18-FPN trunk
(``models/backbone.py``) fed ``images · 2 − 1``, and three dense heads on
its stride-4 map P2:

* keypoints: a two-conv tower → 1×1 conv to 17 heatmap logits;
* silhouette: a two-conv tower → nearest 2× → 3×3 conv to C/2 → nearest
  2× → 3×3 conv to C/4 → 1×1 conv to one full-resolution logit;
* IUV (``with_iuv``): a two-conv tower → 1×1 convs to 25 part logits
  (background + 24 parts) and 48 per-part U, V logits.

The module takes NCHW images and computes in NCHW; its outputs are
permuted once, at the boundary, into the JAX package's channels-last
layout (``kp_logits (B, H/4, W/4, 17)``, ``mask_logits (B, H, W)``,
``part_logits (B, H/4, W/4, 25)``, ``uv (B, H/4, W/4, 48)``), so the
decoders below read like their JAX counterparts. Its convolutions are
cuDNN calls on the card (fp32, TF32 off: ``utils/precision.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.nn import functional as F

from soccerplayershapepose_torch.models.backbone import (
    FPNTrunk, fpn_trunk_r18, upsample2x)

NUM_KEYPOINTS = 17
NUM_PARTS = 24          # DensePose part count
STRIDE = 4


class ProxyNetOutput(NamedTuple):
    kp_logits: torch.Tensor              # (B, H/4, W/4, 17)
    mask_logits: torch.Tensor            # (B, H, W)
    part_logits: Optional[torch.Tensor]  # (B, H/4, W/4, 25)
    uv: Optional[torch.Tensor]           # (B, H/4, W/4, 48)


class ConvTower(nn.Module):
    """``depth`` 3×3 convolutions (padding 1, bias), each with a ReLU."""

    def __init__(self, channels: int, depth: int = 2):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv2d(channels, channels, 3, padding=1) for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = F.relu(conv(x))
        return x


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ProxyNet(nn.Module):
    """Shared-trunk dense predictor for keypoints, silhouette and IUV."""

    def __init__(self, with_iuv: bool = True, channels: int = 128,
                 trunk: Optional[FPNTrunk] = None):
        super().__init__()
        c = channels
        self.with_iuv = with_iuv
        self.channels = c
        self.trunk = trunk if trunk is not None else fpn_trunk_r18(c)
        self.kp_tower = ConvTower(c)
        self.kp_out = nn.Conv2d(c, NUM_KEYPOINTS, 1)
        self.mask_tower = ConvTower(c)
        self.mask_up1 = nn.Conv2d(c, c // 2, 3, padding=1)
        self.mask_up2 = nn.Conv2d(c // 2, c // 4, 3, padding=1)
        self.mask_out = nn.Conv2d(c // 4, 1, 1)
        if with_iuv:
            self.iuv_tower = ConvTower(c)
            self.part_out = nn.Conv2d(c, NUM_PARTS + 1, 1)
            self.uv_out = nn.Conv2d(c, 2 * NUM_PARTS, 1)

    def forward(self, images: torch.Tensor) -> ProxyNetOutput:
        """images: (B, 3, H, W) float in [0, 1]."""
        p2, _ = self.trunk(images * 2.0 - 1.0)
        kp_logits = self.kp_out(self.kp_tower(p2))
        m = upsample2x(self.mask_tower(p2))
        m = upsample2x(F.relu(self.mask_up1(m)))
        m = F.relu(self.mask_up2(m))
        mask_logits = self.mask_out(m)[:, 0]
        part_logits = uv = None
        if self.with_iuv:
            iuv = self.iuv_tower(p2)
            part_logits = _channels_last(self.part_out(iuv))
            uv = _channels_last(self.uv_out(iuv))
        return ProxyNetOutput(_channels_last(kp_logits), mask_logits,
                              part_logits, uv)


def decode_keypoints(kp_logits: torch.Tensor,
                     stride: int = STRIDE) -> torch.Tensor:
    """Heatmap logits (B, h, w, 17) → (B, 17, 3) ``[x, y, score]`` in input
    pixels: the argmax cell, refined on each axis by the vertex of the
    parabola through the log-sigmoid at the cell and its two neighbours
    (offset clipped to ±0.5, 0 where the parabola is flat), clipped into
    the image; the score is the sigmoid of the peak logit."""
    b, h, w, k = kp_logits.shape
    hm = kp_logits.reshape(b, h * w, k)
    idx = torch.argmax(hm, dim=1)                           # (B, K)
    peak = torch.sigmoid(torch.gather(hm, 1, idx[:, None, :])[:, 0, :])
    py = torch.div(idx, w, rounding_mode="floor")
    px = idx % w

    def logp(dy: int, dx: int) -> torch.Tensor:
        yy = torch.clamp(py + dy, 0, h - 1)
        xx = torch.clamp(px + dx, 0, w - 1)
        logits = torch.gather(hm, 1, (yy * w + xx)[:, None, :])[:, 0, :]
        return -F.softplus(-logits)                         # log sigmoid

    def vertex(lo, c, hi):
        denom = lo - 2.0 * c + hi
        flat = torch.abs(denom) < 1e-6
        off = 0.5 * (lo - hi) / torch.where(flat, 1.0, denom)
        off = torch.where(flat, 0.0, off)
        return torch.clamp(off, -0.5, 0.5)

    c = logp(0, 0)
    dx = vertex(logp(0, -1), c, logp(0, 1))
    dy = vertex(logp(-1, 0), c, logp(1, 0))
    x = torch.clamp((px.to(torch.float32) + dx + 0.5) * stride,
                    0.0, w * stride - 1.0)
    y = torch.clamp((py.to(torch.float32) + dy + 0.5) * stride,
                    0.0, h * stride - 1.0)
    return torch.stack([x, y, peak], dim=-1)


def decode_silhouette(mask_logits: torch.Tensor,
                      threshold: float = 0.0) -> torch.Tensor:
    """Full-resolution logits → {0, 1} float mask (B, H, W)."""
    return (mask_logits > threshold).to(torch.float32)


def decode_iuv(part_logits: torch.Tensor, uv: torch.Tensor,
               out_wh: Optional[int] = None) -> torch.Tensor:
    """Part logits (B, h, w, 25) and per-part UV logits (B, h, w, 48) →
    (B, H, W, 3) IUV: channel 0 the part index (0 background, 1..24),
    channels 1-2 the part's U, V scaled to [0, 255] (0 on background).

    With ``out_wh`` the stride-4 maps are upsampled bilinearly (half-pixel
    centres, as ``jax.image.resize``) BEFORE the argmax, so part boundaries
    fall per pixel."""
    b, h, w, _ = part_logits.shape
    if out_wh is not None and out_wh != h:
        def up(x):
            return _channels_last(F.interpolate(
                x.permute(0, 3, 1, 2), size=(out_wh, out_wh),
                mode="bilinear", align_corners=False))
        part_logits, uv = up(part_logits), up(uv)
        h = w = out_wh
    part = torch.argmax(part_logits, dim=-1)                # (B, h, w)
    uv = torch.sigmoid(uv.reshape(b, h, w, NUM_PARTS, 2))
    sel = torch.clamp(part - 1, 0, NUM_PARTS - 1)
    uv_sel = torch.gather(uv, 3, sel[..., None, None].expand(
        -1, -1, -1, 1, 2))[..., 0, :]
    fg = (part > 0).to(torch.float32)
    return torch.stack([part.to(torch.float32),
                        uv_sel[..., 0] * 255.0 * fg,
                        uv_sel[..., 1] * 255.0 * fg], dim=-1)
