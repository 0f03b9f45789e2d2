"""Proxy representation: silhouette + 17 joint heatmaps (+ IUV).

Counterpart of ``soccerplayershapepose_tpu/pipeline/proxy.py`` in PyTorch's
NCHW layout: the JAX package emits (B, H, W, C), this module (B, C, H, W)
with the same values in the same channel order.
"""

from __future__ import annotations

from typing import Optional

import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.ops.heatmaps import (
    joints2d_to_gaussian_heatmaps)


def resize_nearest(images: torch.Tensor, out_wh: int) -> torch.Tensor:
    """Nearest-neighbour resize of the trailing (H, W) axes with
    ``cv2.INTER_NEAREST`` semantics: source index = floor(dst · in/out),
    the product taken in fp32 as the JAX package takes it."""
    in_h, in_w = images.shape[-2], images.shape[-1]
    if in_h % out_wh == 0 and in_w % out_wh == 0:
        return images[..., ::in_h // out_wh, ::in_w // out_wh]
    dst = torch.arange(out_wh, dtype=torch.float32, device=images.device)
    ys = (dst * (in_h / out_wh)).to(torch.long)
    xs = (dst * (in_w / out_wh)).to(torch.long)
    return images[..., ys[:, None], xs[None, :]]


def create_proxy_representation(silhouette: torch.Tensor,
                                joints2d: torch.Tensor,
                                in_wh: int = cfg.PROXY_REP_INPUT_WH,
                                out_wh: int = cfg.REGRESSOR_IMG_WH,
                                iuv: Optional[torch.Tensor] = None,
                                include_silhouette: bool = True
                                ) -> torch.Tensor:
    """(B, in_wh, in_wh) silhouettes and (B, 17, 2|3) keypoints in in_wh
    pixels (a confidence column is ignored), optionally a (B, 3, in_wh,
    in_wh) IUV image in [0, 1] → (B, C, out_wh, out_wh) fp32 proxy with
    C = 18 [sil, heatmaps], 21 [sil, heatmaps, IUV] or, without the
    silhouette, 20."""
    scale = out_wh / float(in_wh)
    # The reference casts the scaled joints to int16 before synthesis.
    joints = torch.trunc(joints2d[..., :2] * scale)
    channels = []
    if include_silhouette:
        channels.append(resize_nearest(silhouette, out_wh)
                        .to(torch.float32)[:, None])
    channels.append(joints2d_to_gaussian_heatmaps(joints, out_wh))
    if iuv is not None:
        channels.append(resize_nearest(iuv, out_wh).to(torch.float32))
    return torch.cat(channels, dim=1)
