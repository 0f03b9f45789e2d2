"""Gaussian joint heatmaps.

Counterpart of ``soccerplayershapepose_tpu/ops/heatmaps.py``, bit-equal to
it, quirks included:

* joint centres are truncated toward zero (``.int()`` semantics);
* the window samples ``linspace(-2σ, 2σ, 4σ)``, so the offsets are not whole
  pixels (spacing ``4σ/(4σ-1)``);
* the window is pasted at ``[c-2σ, min(c+2σ, wh-1))``: the last row and
  column of the image are never written;
* a joint contributes only when ``all(c > -2σ)`` and ``all(c < wh-1+2σ)``
  (strict).
"""

from __future__ import annotations

import torch

from soccerplayershapepose_torch import config as cfg


def joints2d_to_gaussian_heatmaps(joints2d: torch.Tensor, img_wh: int,
                                  std: int = cfg.HEATMAP_STD) -> torch.Tensor:
    """(..., N, 2) joint pixel coordinates → (..., N, img_wh, img_wh) fp32
    heatmaps, (y, x) indexed. Float coordinates are truncated toward zero."""
    size = 2 * std
    n_win = 2 * size                       # Gaussian samples per axis
    step = (2.0 * size) / (n_win - 1)      # linspace(-size, size, n_win)

    c = torch.trunc(joints2d).to(torch.int32)
    flat_c = c.reshape((-1,) + tuple(c.shape[-2:]))        # (B, N, 2)
    px = torch.arange(img_wh, dtype=torch.int32, device=joints2d.device)

    def axis_profile(centre):                              # (M,) → (M, wh)
        g = px[None, :] - (centre[:, None] - size)
        valid = (g >= 0) & (g < n_win) & (px[None, :] <= img_wh - 2)
        u = -size + g.to(torch.float32) * step
        prof = torch.exp(-(u * u) / (2.0 * std * std))
        return torch.where(valid, prof, 0.0)

    profile_x = axis_profile(flat_c[..., 0].reshape(-1))
    profile_y = axis_profile(flat_c[..., 1].reshape(-1))
    joint_ok = torch.all((flat_c > -size) & (flat_c < img_wh - 1 + size),
                         dim=-1).reshape(-1).to(torch.float32)
    # exp(-(ux²+uy²)/2σ²) = exp(-ux²/2σ²)·exp(-uy²/2σ²)
    hm = (profile_y[:, :, None] * profile_x[:, None, :]) \
        * joint_ok[:, None, None]
    return hm.reshape(tuple(joints2d.shape[:-1]) + (img_wh, img_wh))
