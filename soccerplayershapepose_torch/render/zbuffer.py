"""Banded hard z-buffer: nearest covering face and barycentrics per pixel.

Counterpart of ``soccerplayershapepose_tpu/render/pallas_zbuffer.py``. The
Pallas kernel ``_zbuf_kernel`` becomes K3, the CUDA C++ kernel
``zbuffer_bary`` in ``csrc/zbuffer.cu``. The pruning is the band
rasterizer's (``band_raster.py``): faces are y-sorted here, carrying their
three depths beside their 2-D vertices as a (B, F_pad, 9) table
[x0 y0 x1 y1 x2 y2 | z0 z1 z2]; each 8-row band gets the exact
candidate-chunk range [lo, hi) and a chunk whose integer box, padded by
``MARGIN`` = 1 px, misses a block's tile is skipped. The chunk boxes are
exact per chunk (the JAX package groups them in pairs above 2,048 chunks,
an SMEM limit of the TPU). Padding faces are the -1e9 degenerate sentinel,
sorted last. A face that lies far off the image (an absent occluder moved
by +1e5 px) falls out through the band ranges.

Per pixel the result is the covering face of least z, ties to the smallest
sorted face id, its id in the sorted order (-1 where no face covers the
pixel) and its barycentrics w0, w1 (w2 = 1 − w0 − w1). The attribute
gather and interpolation stay in PyTorch, outside the kernel
(:func:`rasterize_attributes_fast`), so one kernel serves every attribute
width. Not differentiable.

:func:`zbuffer_bary` takes CPU tensors to :func:`rasterize_bary_plain`
(dense over all faces, so it also checks the pruning) and CUDA tensors to
the kernel, and raises on anything else.
"""

from __future__ import annotations

import torch

from soccerplayershapepose_torch.render.band_raster import (
    BAND_H, CHUNK, SENTINEL, TILE_W, _band_chunk_bounds, _check, _ptr,
    _stream)

MARGIN = 1.0
# Elements per (B, faces, pixels) intermediate of the plain version.
_PLAIN_ELEMS = {"cpu": 1 << 22, "cuda": 1 << 25}

# Launches of the kernel since the last reset_launch_counts(); the wrapper
# adds one where it launches the kernel and nowhere else.
LAUNCHES = {"zbuffer_bary": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Host glue
# ---------------------------------------------------------------------------

def _sorted_tri_z_and_ranges(verts2d: torch.Tensor, verts_z: torch.Tensor,
                             faces: torch.Tensor):
    """y-sorted (B, F_pad, 9) [xyxyxy|zzz] table and exact chunk boxes.

    Returns ``(tri9, order (B, F) int64, cymin, cymax, cxmin, cxmax
    (B, n_chunks) int32, n_chunks)``. The sort is stable, as
    ``jnp.argsort``; the padding faces carry the -1e9 sentinel and come
    last.
    """
    b = verts2d.shape[0]
    f = faces.shape[0]
    fl = faces.to(torch.long)
    tri = verts2d[:, fl].reshape(b, f, 6)
    tz = verts_z[:, fl]                                       # (B, F, 3)
    order = torch.argsort(torch.amin(tri[..., 1::2], dim=-1), dim=-1,
                          stable=True)
    tri9 = torch.cat([torch.gather(tri, 1, order[..., None].expand(-1, -1, 6)),
                      torch.gather(tz, 1, order[..., None].expand(-1, -1, 3))],
                     dim=-1)
    n_chunks = -(-f // CHUNK)
    pad = n_chunks * CHUNK - f
    if pad:
        tri9 = torch.cat([tri9, tri9.new_full((b, pad, 9), SENTINEL)], dim=1)

    def ranges(coords):
        sent = (coords[..., 0] < -1e8)[..., None]
        lo = torch.where(sent, torch.full_like(coords, 1e9), coords)
        hi = torch.where(sent, torch.full_like(coords, -1e9), coords)
        lo = torch.amin(lo.reshape(b, n_chunks, CHUNK * 3), dim=-1)
        hi = torch.amax(hi.reshape(b, n_chunks, CHUNK * 3), dim=-1)
        return (torch.floor(lo).to(torch.int32).contiguous(),
                torch.ceil(hi).to(torch.int32).contiguous())

    cymin, cymax = ranges(tri9[..., 1:6:2])
    cxmin, cxmax = ranges(tri9[..., 0:6:2])
    return tri9.contiguous(), order, cymin, cymax, cxmin, cxmax, n_chunks


# ---------------------------------------------------------------------------
# Plain version of the kernel (dense over every face; the CPU path)
# ---------------------------------------------------------------------------

def rasterize_bary_plain(tri9: torch.Tensor, img_wh: int):
    """What K3 computes, over every (face, pixel) pair of the sorted table:
    ``(fid (B, wh, wh) int32, w0, w1 (B, wh, wh) f32)``.

    The same fp32 steps as the kernel, each a separate PyTorch op: edge
    functions, area = e0 + e1 + e2, the inside test, inv_area = 1/area,
    w = e·inv_area, z = w0·z0 + w1·z1 + (1 − w0 − w1)·z2. Within a chunk
    of faces the least z wins, ties to the first face; a later chunk
    replaces the winner only with a strictly smaller z. So the order is
    the kernel's: least z, then smallest sorted id.
    """
    b, f_pad, _ = tri9.shape
    dev = tri9.device
    p = img_wh * img_wh
    step = max(1, min(f_pad, _PLAIN_ELEMS.get(dev.type, 1 << 22) // (b * p)))
    coords = torch.arange(img_wh, dtype=torch.float32, device=dev)
    py, px = (g.reshape(1, 1, p)
              for g in torch.meshgrid(coords, coords, indexing="ij"))
    best_z = torch.full((b, p), float("inf"), device=dev)
    best_f = torch.full((b, p), -1, dtype=torch.int32, device=dev)
    best_w0 = torch.zeros((b, p), device=dev)
    best_w1 = torch.zeros((b, p), device=dev)
    for s in range(0, f_pad, step):
        t = tri9[:, s:s + step]
        ax, ay, bx, by, cx, cy, z0, z1, z2 = (
            v[..., None] for v in t.unbind(-1))

        def edge(xa, ya, xb, yb):
            return (xb - xa) * (py - ya) - (yb - ya) * (px - xa)

        e0 = edge(bx, by, cx, cy)          # opposite vertex 0
        e1 = edge(cx, cy, ax, ay)          # opposite vertex 1
        e2 = edge(ax, ay, bx, by)          # opposite vertex 2
        area = e0 + e1 + e2                # twice the signed area
        nondeg = torch.abs(area) > 1e-9
        inside = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
                  | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))) & nondeg
        inv_area = 1.0 / torch.where(nondeg, area, 1.0)
        w0 = e0 * inv_area
        w1 = e1 * inv_area
        z = w0 * z0 + w1 * z1 + (1.0 - w0 - w1) * z2
        z = torch.where(inside, z, float("inf"))

        zc = torch.amin(z, dim=1)                                 # (B, P)
        n = z.shape[1]
        ids = torch.arange(n, device=dev)[None, :, None]
        first = torch.amin(torch.where(z <= zc[:, None], ids, n), dim=1)
        sel = first.clamp(max=n - 1)[:, None]
        better = zc < best_z
        best_z = torch.where(better, zc, best_z)
        best_f = torch.where(better, (first + s).to(torch.int32), best_f)
        best_w0 = torch.where(better, torch.gather(w0, 1, sel)[:, 0], best_w0)
        best_w1 = torch.where(better, torch.gather(w1, 1, sel)[:, 0], best_w1)
    shape = (b, img_wh, img_wh)
    return (best_f.reshape(shape), best_w0.reshape(shape),
            best_w1.reshape(shape))


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _check_inputs(tri9, cymin, cymax, cxmin, cxmax, lo, hi, img_wh):
    if not isinstance(tri9, torch.Tensor) or tri9.dim() != 3 \
            or tri9.shape[-1] != 9:
        raise ValueError("tri9 must be a (B, F_pad, 9) tensor")
    if tri9.device.type != "cuda":
        raise ValueError(
            f"the z-buffer kernel takes CUDA tensors, got {tri9.device}")
    b, f_pad, _ = tri9.shape
    n_chunks = cymin.shape[-1] if cymin.dim() == 2 else -1
    if n_chunks <= 0 or f_pad % n_chunks:
        raise ValueError("F_pad must be n_chunks · chunk")
    dev = tri9.device
    _check(tri9, "tri9", torch.float32, (b, f_pad, 9), dev)
    for name, t in (("cymin", cymin), ("cymax", cymax), ("cxmin", cxmin),
                    ("cxmax", cxmax)):
        _check(t, name, torch.int32, (b, n_chunks), dev)
    n_bands = -(-img_wh // BAND_H)
    _check(lo, "lo", torch.int32, (b, n_bands), dev)
    _check(hi, "hi", torch.int32, (b, n_bands), dev)
    return b, n_chunks, f_pad // n_chunks


def launch_zbuffer(tri9, cymin, cymax, cxmin, cxmax, lo, hi, img_wh: int):
    """Launch K3 on CUDA tensors; anything else raises. Returns
    ``(fid int32, w0, w1 f32)``, each (B, wh, wh)."""
    from soccerplayershapepose_torch._build import load_library
    b, n_chunks, chunk = _check_inputs(tri9, cymin, cymax, cxmin, cxmax, lo,
                                       hi, img_wh)
    shape = (b, img_wh, img_wh)
    fid = torch.empty(shape, dtype=torch.int32, device=tri9.device)
    w0 = torch.empty(shape, dtype=torch.float32, device=tri9.device)
    w1 = torch.empty(shape, dtype=torch.float32, device=tri9.device)
    lib = load_library()
    with torch.cuda.device(tri9.device):
        rc = lib.spt_zbuffer_bary(
            _ptr(tri9), _ptr(cymin), _ptr(cymax), _ptr(cxmin), _ptr(cxmax),
            _ptr(lo), _ptr(hi), _ptr(fid), _ptr(w0), _ptr(w1), b, n_chunks,
            chunk, img_wh, BAND_H, TILE_W, MARGIN,
            _stream(tri9.device))
    if rc != 0:
        raise RuntimeError(f"zbuffer_bary launch failed: CUDA error {rc}")
    LAUNCHES["zbuffer_bary"] += 1
    return fid, w0, w1


def zbuffer_bary(tri9, cymin, cymax, cxmin, cxmax, lo, hi, img_wh: int):
    """K3: ``(fid, w0, w1)`` from the sorted table and its ranges. CPU
    tensors take :func:`rasterize_bary_plain`."""
    if tri9.device.type == "cpu":
        return rasterize_bary_plain(tri9, img_wh)
    return launch_zbuffer(tri9, cymin, cymax, cxmin, cxmax, lo, hi, img_wh)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def rasterize_bary(verts2d: torch.Tensor, verts_z: torch.Tensor,
                   faces: torch.Tensor, img_wh: int):
    """Per-pixel nearest face and barycentrics.

    (B, V, 2) pixel-space vertices, (B, V) depths (smaller is nearer),
    (F, 3) faces → ``(sorted_fid (B, wh, wh) int32, -1 where empty;
    w (B, wh, wh, 3); order (B, F) sorted → original face id;
    mask (B, wh, wh) bool)``.
    """
    tri9, order, cymin, cymax, cxmin, cxmax, _ = _sorted_tri_z_and_ranges(
        verts2d, verts_z, faces)
    lo, hi = _band_chunk_bounds(cymin, cymax, -(-img_wh // BAND_H), BAND_H,
                                MARGIN)
    fid, w0, w1 = zbuffer_bary(tri9, cymin, cymax, cxmin, cxmax, lo, hi,
                               img_wh)
    w = torch.stack([w0, w1, 1.0 - w0 - w1], dim=-1)
    return fid, w, order, fid >= 0


def rasterize_attributes_fast(verts2d: torch.Tensor, verts_z: torch.Tensor,
                              vert_attrs: torch.Tensor, faces: torch.Tensor,
                              img_wh: int):
    """(B, V, A) per-vertex attributes interpolated at each pixel's nearest
    face: ``(attrs (B, wh, wh, A), mask (B, wh, wh) bool)``. The kernel
    finds the face; the gather and the barycentric sum run here."""
    fid, w, order, mask = rasterize_bary(verts2d, verts_z, faces, img_wh)
    return interpolate_attributes(fid, w, order, mask, faces, vert_attrs)


def interpolate_attributes(fid: torch.Tensor, w: torch.Tensor,
                           order: torch.Tensor, mask: torch.Tensor,
                           faces: torch.Tensor, vert_attrs: torch.Tensor):
    """(B, V, A) attributes at each pixel's face (sorted ids ``fid``,
    barycentrics ``w``, the sort ``order``): ``(attrs (B, wh, wh, A),
    mask)``, zero where ``mask`` is False."""
    b, _, a = vert_attrs.shape
    img_wh = fid.shape[-1]
    p = img_wh * img_wh
    sid = fid.reshape(b, p).clamp(min=0).to(torch.long)
    orig = torch.gather(order, 1, sid)                       # (B, P)
    fv = faces.to(torch.long)[orig]                          # (B, P, 3)
    attrs3 = torch.gather(vert_attrs, 1,
                          fv.reshape(b, 3 * p, 1).expand(-1, -1, a))
    out = torch.einsum("bpk,bpka->bpa", w.reshape(b, p, 3),
                       attrs3.reshape(b, p, 3, a))
    out = out * mask.reshape(b, p, 1)
    return out.reshape(b, img_wh, img_wh, a), mask
