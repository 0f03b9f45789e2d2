"""Plain soft silhouette over each face's support, and its backward.

SoftRas coverage: a pixel centre at squared distance d² from a triangle
(positive inside, either winding, degenerate faces never inside) is
covered by ``D = min(sigmoid(±d²/σ_px), 1 − 1e-7)``, σ_px = σ·(wh/2)²,
and ``S = 1 − Π(1 − D)`` over the faces. Beyond d² = 20.1·σ_px a face
covers less than 2e-9, so each face is evaluated only on the pixels of
its bounding box padded by √(20.1·σ_px): the pairs are listed with
:func:`benchmark.pairs.enumerate_pairs`, not a dense (face, pixel) grid.
Back faces (all but the 60% of largest signed area) are dropped first.

The backward takes dS/d(d²) = (1 − S)·D/σ_px·sign through the nearest
edge (the envelope of the clamped projection), as the published
derivation does: the clamp of D passes its gradient unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import pairs

D_MAX = float(np.float32(1.0 - 1e-7))
SUPPORT_D2 = 20.1


class _Cover(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pix, n_pix: int):
        d = torch.clamp(torch.sigmoid(x), max=D_MAX)
        log_miss = torch.zeros(n_pix, device=x.device).index_add_(
            0, pix, torch.log1p(-d))
        s = 1.0 - torch.exp(log_miss)
        ctx.save_for_backward(d, pix, s)
        return s

    @staticmethod
    def backward(ctx, g):
        d, pix, s = ctx.saved_tensors
        return (g * (1.0 - s))[pix] * d, None, None


def _edge(x, y, p0, p1):
    ex, ey = p1[:, 0] - p0[:, 0], p1[:, 1] - p0[:, 1]
    pxr, pyr = x - p0[:, 0], y - p0[:, 1]
    cross = ex * pyr - ey * pxr
    iee = 1.0 / torch.clamp(ex * ex + ey * ey, min=1e-12)
    t = torch.clamp((pxr * ex + pyr * ey) * iee, 0.0, 1.0)
    rx, ry = pxr - t * ex, pyr - t * ey
    return cross, rx * rx + ry * ry


def soft_silhouette(verts2d: torch.Tensor, faces: torch.Tensor, wh: int,
                    sigma: float) -> torch.Tensor:
    """(B, wh, wh) soft silhouettes of (B, V, 2) pixel-space vertices,
    differentiable in ``verts2d``."""
    b, f = verts2d.shape[0], faces.shape[0]
    sigma_px = sigma * (wh / 2.0) ** 2
    inv_sigma = float(np.float32(1.0 / sigma_px))
    tri = verts2d[:, faces]                                  # (B, F, 3, 2)
    with torch.no_grad():
        keep = pairs.front_faces(tri)
        row, face = torch.nonzero(keep, as_tuple=True)
        boxes = pairs.face_boxes(tri[row, face], (SUPPORT_D2 * sigma_px)
                                 ** 0.5)
        k, px, py = pairs.enumerate_pairs(boxes, wh)
        bf = (row * f + face)[k]
        pix = (row[k] * wh + py) * wh + px
    t = tri.reshape(b * f, 3, 2)[bf]                          # (P, 3, 2)
    x, y = px.to(torch.float32), py.to(torch.float32)
    c0, d0 = _edge(x, y, t[:, 0], t[:, 1])
    c1, d1 = _edge(x, y, t[:, 1], t[:, 2])
    c2, d2 = _edge(x, y, t[:, 2], t[:, 0])
    nondeg = torch.abs(pairs.signed_area(t.detach())) > 1e-9
    inside = (((c0 >= 0) & (c1 >= 0) & (c2 >= 0))
              | ((c0 <= 0) & (c1 <= 0) & (c2 <= 0))) & nondeg
    dmin = torch.minimum(d0, torch.minimum(d1, d2))
    z = torch.where(inside, dmin, -dmin) * inv_sigma
    z = torch.where(nondeg, z, z.detach())
    s = _Cover.apply(z, pix, b * wh * wh)
    return s.reshape(b, wh, wh)
