"""Differentiable soft-silhouette rasterizer: the plain PyTorch version.

Counterpart of ``soccerplayershapepose_tpu/render/softras.py`` (SoftRas, Liu
et al. ICCV'19). Per (pixel, face) the soft coverage is
``D = sigmoid(sign · d² / σ_px)`` with ``d`` the distance from the pixel
centre to the triangle (positive inside), aggregated in log space as
``S = 1 − exp(Σ log1p(−min(D, 1 − 1e-7)))``.

This module evaluates every (face, pixel) pair in chunks of faces, each
chunk under ``torch.utils.checkpoint`` so the backward recomputes it and
autograd keeps only the running sum per chunk. It is the oracle of the CUDA
kernels in ``render/band_raster.py`` and the path every CPU tensor takes.
:func:`render_silhouette` sends CUDA tensors to the kernels.
:func:`hard_silhouette` is the binary coverage the metrics read.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from soccerplayershapepose_torch.ops.camera import perspective_project

# float32(1 - 1e-7): the coverage clamp that keeps log1p(-D) finite.
D_MAX = 1.0 - 1e-7


def pixel_grid(img_wh: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat (P,) pixel-centre x and y coordinates, row-major (y, x)."""
    coords = torch.arange(img_wh, dtype=torch.float32, device=device)
    py, px = torch.meshgrid(coords, coords, indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def edge_terms(px, py, x0, y0, x1, y1):
    """Per (face, pixel) terms of one edge (x0, y0) → (x1, y1).

    ``px, py``: (P,); endpoints: (B, C). Returns, each (B, C, P), the edge
    function ``cross``, the squared distance ``d2`` to the segment, the
    clamped projection ``t`` and the residual ``(rx, ry)``.
    """
    ex = (x1 - x0)[..., None]
    ey = (y1 - y0)[..., None]
    pxr = px - x0[..., None]
    pyr = py - y0[..., None]
    cross = ex * pyr - ey * pxr
    ee = ex * ex + ey * ey
    t = torch.clamp((pxr * ex + pyr * ey) / torch.clamp(ee, min=1e-12),
                    0.0, 1.0)
    rx = pxr - t * ex
    ry = pyr - t * ey
    return cross, rx * rx + ry * ry, t, rx, ry


def triangle_terms(px, py, tri):
    """Edge terms of the three edges of ``tri`` (B, C, 3, 2), the inside
    mask (either winding, degenerate faces never inside) and ``nondeg``."""
    ax, ay = tri[..., 0, 0], tri[..., 0, 1]
    bx, by = tri[..., 1, 0], tri[..., 1, 1]
    cx, cy = tri[..., 2, 0], tri[..., 2, 1]
    e0 = edge_terms(px, py, ax, ay, bx, by)
    e1 = edge_terms(px, py, bx, by, cx, cy)
    e2 = edge_terms(px, py, cx, cy, ax, ay)
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    nondeg = (torch.abs(area) > 1e-9)[..., None]
    c0, c1, c2 = e0[0], e1[0], e2[0]
    inside = (((c0 >= 0) & (c1 >= 0) & (c2 >= 0))
              | ((c0 <= 0) & (c1 <= 0) & (c2 <= 0))) & nondeg
    return (e0, e1, e2), inside, nondeg


def point_triangle_coverage(px, py, tri, sigma):
    """(B, C, P) soft coverage of pixels by triangles ``tri`` (B, C, 3, 2)."""
    (e0, e1, e2), inside, _ = triangle_terms(px, py, tri)
    d2min = torch.minimum(e0[1], torch.minimum(e1[1], e2[1]))
    signed = torch.where(inside, d2min, -d2min)
    return torch.sigmoid(signed / sigma)


def cull_backfaces(verts2d: torch.Tensor, faces: torch.Tensor,
                   keep_fraction: float = 0.6) -> torch.Tensor:
    """(B, K, 3) per-sample faces: the ``keep_fraction``·F faces with the
    largest signed screen-space area (a closed mesh's silhouette is the
    union of its front faces)."""
    tri = verts2d[:, faces]                                # (B, F, 3, 2)
    ax, ay = tri[..., 0, 0], tri[..., 0, 1]
    bx, by = tri[..., 1, 0], tri[..., 1, 1]
    cx, cy = tri[..., 2, 0], tri[..., 2, 1]
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    k = max(1, int(faces.shape[0] * keep_fraction))
    idx = torch.topk(area.detach(), k, dim=1).indices      # (B, K)
    return faces[idx]


def soft_silhouette(verts2d: torch.Tensor,
                    faces: torch.Tensor,
                    img_wh: int,
                    sigma: float = 1e-5,
                    faces_per_chunk: int = 86) -> torch.Tensor:
    """Render (B, img_wh, img_wh) soft silhouettes from (B, V, 2) pixel-space
    vertices.

    ``faces`` is (F, 3) shared or (B, F, 3) per sample (from
    :func:`cull_backfaces`). ``sigma`` is in normalised units (image
    half-size 1) and becomes ``σ_px = sigma·(wh/2)²``.
    """
    b = verts2d.shape[0]
    per_sample = faces.ndim == 3
    f = faces.shape[-2]
    sigma_px = sigma * (img_wh / 2.0) ** 2
    n_chunks = -(-f // faces_per_chunk)
    pad = n_chunks * faces_per_chunk - f
    faces = faces.to(torch.long)
    if pad:
        zeros = faces.new_zeros(faces.shape[:-2] + (pad, 3))
        faces = torch.cat([faces, zeros], dim=-2)
    valid = (torch.arange(n_chunks * faces_per_chunk, device=faces.device)
             < f).reshape(n_chunks, faces_per_chunk)
    px, py = pixel_grid(img_wh, verts2d.device)

    def step(carry, verts, fidx, ok):
        if per_sample:
            tri = torch.gather(
                verts, 1, fidx.reshape(b, -1, 1).expand(-1, -1, 2)
            ).reshape(b, faces_per_chunk, 3, 2)
        else:
            tri = verts[:, fidx]
        d = point_triangle_coverage(px, py, tri, sigma_px)
        d = torch.where(ok[None, :, None], d, torch.zeros_like(d))
        d = torch.clamp(d, max=D_MAX)
        return carry + torch.sum(torch.log1p(-d), dim=1)

    log_miss = torch.zeros((b, img_wh * img_wh), dtype=torch.float32,
                           device=verts2d.device)
    use_ckpt = torch.is_grad_enabled() and verts2d.requires_grad
    for c in range(n_chunks):
        sl = slice(c * faces_per_chunk, (c + 1) * faces_per_chunk)
        fidx = faces[:, sl] if per_sample else faces[sl]
        if use_ckpt:
            log_miss = checkpoint(step, log_miss, verts2d, fidx, valid[c],
                                  use_reentrant=False)
        else:
            log_miss = step(log_miss, verts2d, fidx, valid[c])
    return (1.0 - torch.exp(log_miss)).reshape(b, img_wh, img_wh)


@torch.no_grad()
def hard_silhouette(verts2d: torch.Tensor, faces: torch.Tensor,
                    img_wh: int, faces_per_chunk: int = 86) -> torch.Tensor:
    """(B, img_wh, img_wh) binary coverage: 1 where a pixel centre lies
    inside some face of ``faces`` (F, 3), edges included, either winding;
    the metric-side counterpart of :func:`soft_silhouette`, chunk by chunk
    over the faces. No gradient."""
    b = verts2d.shape[0]
    faces = faces.to(torch.long)
    px, py = pixel_grid(img_wh, verts2d.device)
    covered = torch.zeros((b, img_wh * img_wh), dtype=torch.bool,
                          device=verts2d.device)

    def cross(x0, y0, x1, y1):
        return ((x1 - x0)[..., None] * (py - y0[..., None])
                - (y1 - y0)[..., None] * (px - x0[..., None]))

    for s in range(0, faces.shape[0], faces_per_chunk):
        tri = verts2d[:, faces[s:s + faces_per_chunk]]      # (B, c, 3, 2)
        ax, ay = tri[..., 0, 0], tri[..., 0, 1]
        bx, by = tri[..., 1, 0], tri[..., 1, 1]
        cx, cy = tri[..., 2, 0], tri[..., 2, 1]
        c0 = cross(ax, ay, bx, by)
        c1 = cross(bx, by, cx, cy)
        c2 = cross(cx, cy, ax, ay)
        inside = (((c0 >= 0) & (c1 >= 0) & (c2 >= 0))
                  | ((c0 <= 0) & (c1 <= 0) & (c2 <= 0)))
        covered |= inside.any(dim=1)
    return covered.reshape(b, img_wh, img_wh).to(torch.float32)


def render_silhouette(vertices: torch.Tensor,
                      translation: torch.Tensor,
                      faces: torch.Tensor,
                      img_wh: int,
                      focal_length: float,
                      sigma: float = 1e-5,
                      render_wh: Optional[int] = None,
                      backface_cull: bool = False,
                      faces_per_chunk: int = 86) -> torch.Tensor:
    """Perspective-project SMPL vertices and rasterize the soft silhouette.

    Identity camera rotation, K from ``focal_length`` with the principal
    point at ``img_wh/2``; ``render_wh`` rasterizes at a lower resolution.
    CUDA tensors go through the banded CUDA kernels
    (:class:`~soccerplayershapepose_torch.render.band_raster.SoftSilhouetteBand`),
    CPU tensors through the plain version in this module.
    """
    render_wh = render_wh or img_wh
    verts2d = perspective_project(vertices, None, translation,
                                  focal_length=focal_length, img_wh=img_wh)
    if render_wh != img_wh:
        verts2d = verts2d * (render_wh / img_wh)
    if verts2d.is_cuda:
        from soccerplayershapepose_torch.render.band_raster import (
            soft_silhouette_band)
        return soft_silhouette_band(verts2d, faces, render_wh, sigma,
                                    backface_cull)
    if backface_cull:
        faces = cull_backfaces(verts2d, faces)
    return soft_silhouette(verts2d, faces, render_wh, sigma=sigma,
                           faces_per_chunk=faces_per_chunk)
