"""ROIAlign: bilinear samples averaged per output cell.

Counterpart of ``soccerplayershapepose_tpu/ops/roi_align.py``, in plain
PyTorch gathers on channels-last maps. Each output cell averages
``sampling_ratio²`` bilinear samples on a regular sub-grid of the box;
``aligned=True`` applies the half-pixel offset. Samples outside the map
clamp to its edge. The sample grid is computed in the JAX function's order
of operations, so the two agree to fp32 rounding.
"""

from __future__ import annotations

import torch


def _bilinear_sample(fmap: torch.Tensor, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """fmap (F, H, W, C); ys, xs (F, ...) of equal shapes → (F, ..., C):
    sample j of ``ys[f]``/``xs[f]`` read from ``fmap[f]``."""
    f, h, w, c = fmap.shape
    y0 = torch.clamp(torch.floor(ys), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)[..., None]
    wx = torch.clamp(xs - x0, 0.0, 1.0)[..., None]
    flat = fmap.reshape(f * h * w, c)
    base = (torch.arange(f, device=fmap.device) * (h * w)).reshape(
        (f,) + (1,) * (ys.dim() - 1))

    def at(yi, xi):
        return flat[base + yi.to(torch.long) * w + xi.to(torch.long)]

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def roi_align(features: torch.Tensor, boxes: torch.Tensor,
              output_size: int = 7, spatial_scale: float = 1.0,
              sampling_ratio: int = 2, aligned: bool = True) -> torch.Tensor:
    """features (H, W, C) and boxes (N, 4) [x1, y1, x2, y2] in input-image
    coordinates → (N, output_size, output_size, C); or a batch: features
    (F, H, W, C) and boxes (F, N, 4), box set f cut from map f →
    (F, N, output_size, output_size, C)."""
    single = features.dim() == 3
    if single:
        features, boxes = features[None], boxes[None]
    offset = 0.5 if aligned else 0.0
    b = boxes * spatial_scale - offset
    x1, y1, x2, y2 = b.unbind(-1)                             # (F, N)
    roi_w = torch.clamp(x2 - x1, min=1e-6)
    roi_h = torch.clamp(y2 - y1, min=1e-6)
    s, o = sampling_ratio, output_size
    dev = features.device
    # Sample k of output cell i at y1 + (i + (k + 0.5)/s)/o · roi_h.
    cell = (torch.arange(o, device=dev)[:, None]
            + (torch.arange(s, device=dev)[None, :] + 0.5) / s)
    cell = cell.reshape(-1) / o                               # (o·s,)
    ys = y1[..., None] + cell * roi_h[..., None]              # (F, N, o·s)
    xs = x1[..., None] + cell * roi_w[..., None]
    fn, n, m = ys.shape
    yy = ys[..., :, None].expand(fn, n, m, m)
    xx = xs[..., None, :].expand(fn, n, m, m)
    sampled = _bilinear_sample(features, yy, xx)              # (F, N, m, m, C)
    c = sampled.shape[-1]
    pooled = sampled.reshape(fn, n, o, s, o, s, c).mean(dim=(3, 5))
    return pooled[0] if single else pooled
