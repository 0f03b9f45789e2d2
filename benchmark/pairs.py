"""(face, pixel) pairs of boxes on a pixel grid.

A pixel belongs to a box [x0, x1] × [y0, y1] when its integer centre
(x, y), 0 ≤ x, y < wh, lies in it, edges included; a box with a NaN side
holds none. :func:`span` gives each box's first pixel and count per axis,
:func:`enumerate_pairs` lists every pair. The traffic generators rasterise
with them, the reference silhouette evaluates its support with them, and
:mod:`benchmark.counts` counts the rasterizers' work with them.
"""

from __future__ import annotations

import torch


def span(lo: torch.Tensor, hi: torch.Tensor, wh: int):
    """(first, count) int64 of the pixel indices in [0, wh) whose centre
    lies in [lo, hi]."""
    first = torch.clamp(torch.ceil(lo), min=0.0)
    last = torch.clamp(torch.floor(hi), max=float(wh - 1))
    n = torch.clamp(last - first + 1.0, min=0.0)
    n = torch.where(lo <= hi, n, torch.zeros_like(n)).to(torch.int64)
    return torch.nan_to_num(first).to(torch.int64), n


def count_pairs(boxes: torch.Tensor, wh: int) -> int:
    """Pairs of boxes (..., 4) [x0, x1, y0, y1]."""
    x0, x1, y0, y1 = boxes.unbind(-1)
    return int((span(x0, x1, wh)[1] * span(y0, y1, wh)[1]).sum())


def enumerate_pairs(boxes: torch.Tensor, wh: int):
    """(box index (P,), x (P,), y (P,)) int64 of every pair of boxes
    (N, 4) [x0, x1, y0, y1], box by box, row-major inside a box."""
    x0, x1, y0, y1 = boxes.unbind(-1)
    fx, nx = span(x0, x1, wh)
    fy, ny = span(y0, y1, wh)
    n = nx * ny
    idx = torch.repeat_interleave(torch.arange(n.shape[0],
                                               device=boxes.device), n)
    start = torch.cumsum(n, 0) - n
    k = torch.arange(idx.shape[0], device=boxes.device) - start[idx]
    w = nx[idx]
    return idx, fx[idx] + k % w, fy[idx] + torch.div(k, w,
                                                      rounding_mode="floor")


def face_boxes(tri: torch.Tensor, radius: float) -> torch.Tensor:
    """(..., 4) [x0, x1, y0, y1] of triangles (..., 3, 2), padded by
    ``radius`` px."""
    x, y = tri[..., 0], tri[..., 1]
    return torch.stack([x.amin(-1) - radius, x.amax(-1) + radius,
                        y.amin(-1) - radius, y.amax(-1) + radius], -1)


def signed_area(tri: torch.Tensor) -> torch.Tensor:
    (ax, ay), (bx, by), (cx, cy) = (tri[..., i, :].unbind(-1)
                                    for i in range(3))
    return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)


def front_faces(tri: torch.Tensor, keep: float = 0.6) -> torch.Tensor:
    """(B, F) bool: the faces whose signed area is at least the k-th
    largest of their row, k = keep·F (a closed mesh's silhouette is the
    union of its front faces)."""
    area = signed_area(tri)
    k = max(1, int(tri.shape[1] * keep))
    return area >= torch.topk(area, k, dim=1).values[:, -1:]
