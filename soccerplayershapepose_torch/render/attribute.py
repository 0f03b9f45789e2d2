"""Z-buffered attribute rasterization.

Counterpart of ``soccerplayershapepose_tpu/render/attribute.py``: for each
pixel keep the nearest covering face and interpolate its per-vertex
attributes barycentrically. :func:`rasterize_attributes` dispatches on the
tensors' device, as the JAX function does on its platform: CUDA tensors go
through the z-buffer kernel K3 (``render/zbuffer.py``), CPU tensors through
:func:`rasterize_attributes_plain`, the counterpart of the JAX package's
``rasterize_attributes_xla`` oracle. Not differentiable.
"""

from __future__ import annotations

import torch

from soccerplayershapepose_torch.render.zbuffer import (
    rasterize_attributes_fast)

# Faces per step of the plain version, as the JAX oracle's scan takes them.
_FACES_PER_CHUNK = 86


def rasterize_attributes(verts2d: torch.Tensor, verts_z: torch.Tensor,
                         vert_attrs: torch.Tensor, faces: torch.Tensor,
                         img_wh: int):
    """Nearest-face barycentric attribute rasterization.

    (B, V, 2) pixel coordinates, (B, V) depths (smaller is nearer),
    (B, V, A) attributes, (F, 3) faces → ``(attrs (B, wh, wh, A),
    mask (B, wh, wh) bool)``. CUDA tensors launch K3; CPU tensors take the
    plain version.
    """
    if verts2d.device.type == "cpu":
        return rasterize_attributes_plain(verts2d, verts_z, vert_attrs, faces,
                                          img_wh)
    return rasterize_attributes_fast(verts2d, verts_z, vert_attrs, faces,
                                     img_wh)


def rasterize_attributes_plain(verts2d: torch.Tensor, verts_z: torch.Tensor,
                               vert_attrs: torch.Tensor, faces: torch.Tensor,
                               img_wh: int):
    """Dense over the faces in their original order, chunk by chunk, with
    the JAX oracle's arithmetic (``w2 = e2·inv_area``): within a chunk the
    least z wins, ties to the first face; a later chunk wins only with a
    strictly smaller z."""
    b = verts2d.shape[0]
    a = vert_attrs.shape[-1]
    f = faces.shape[0]
    p = img_wh * img_wh
    dev = verts2d.device
    fl = faces.to(torch.long)
    coords = torch.arange(img_wh, dtype=torch.float32, device=dev)
    py, px = (g.reshape(1, 1, p)
              for g in torch.meshgrid(coords, coords, indexing="ij"))
    best_z = torch.full((b, p), float("inf"), device=dev)
    best_attr = torch.zeros((b, p, a), dtype=vert_attrs.dtype, device=dev)
    for s in range(0, f, _FACES_PER_CHUNK):
        fidx = fl[s:s + _FACES_PER_CHUNK]                      # (c, 3)
        tri = verts2d[:, fidx]                                # (B, c, 3, 2)
        tz = verts_z[:, fidx]                                 # (B, c, 3)
        x0, y0 = tri[..., 0, 0, None], tri[..., 0, 1, None]
        x1, y1 = tri[..., 1, 0, None], tri[..., 1, 1, None]
        x2, y2 = tri[..., 2, 0, None], tri[..., 2, 1, None]

        def edge(xa, ya, xb, yb):
            return (xb - xa) * (py - ya) - (yb - ya) * (px - xa)

        e0 = edge(x1, y1, x2, y2)          # opposite vertex 0
        e1 = edge(x2, y2, x0, y0)          # opposite vertex 1
        e2 = edge(x0, y0, x1, y1)          # opposite vertex 2
        area = e0 + e1 + e2
        nondeg = torch.abs(area) > 1e-9
        inside = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
                  | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))) & nondeg
        inv_area = 1.0 / torch.where(nondeg, area, 1.0)
        w0 = e0 * inv_area
        w1 = e1 * inv_area
        w2 = e2 * inv_area
        z = (w0 * tz[..., 0, None] + w1 * tz[..., 1, None]
             + w2 * tz[..., 2, None])
        z = torch.where(inside, z, float("inf"))              # (B, c, P)

        zmin = torch.amin(z, dim=1)
        c = z.shape[1]
        ids = torch.arange(c, device=dev)[None, :, None]
        sel = torch.amin(torch.where(z <= zmin[:, None], ids, c),
                         dim=1).clamp(max=c - 1)              # (B, P)
        w_sel = torch.stack([torch.gather(w, 1, sel[:, None])[:, 0]
                             for w in (w0, w1, w2)], dim=-1)  # (B, P, 3)
        vid = fidx[sel]                                       # (B, P, 3)
        attr_sel = torch.gather(
            vert_attrs, 1, vid.reshape(b, 3 * p, 1).expand(-1, -1, a)
        ).reshape(b, p, 3, a)
        interp = torch.einsum("bpk,bpka->bpa", w_sel, attr_sel)
        better = zmin < best_z
        best_z = torch.where(better, zmin, best_z)
        best_attr = torch.where(better[..., None], interp, best_attr)
    mask = torch.isfinite(best_z).reshape(b, img_wh, img_wh)
    return best_attr.reshape(b, img_wh, img_wh, a), mask
