"""Banded hard z-buffer: nearest covering face and barycentrics per pixel.

Counterpart of ``soccerplayershapepose_tpu/render/pallas_zbuffer.py``. The
Pallas kernel ``_zbuf_kernel`` becomes K3, the CUDA C++ kernel
``zbuffer_bary`` in ``csrc/zbuffer.cu``. The coarse pruning is the band
rasterizer's (``band_raster.py``): faces are y-sorted here, carrying their
three depths beside their 2-D vertices as a (B, F_pad, 9) table
[x0 y0 x1 y1 x2 y2 | z0 z1 z2]; each 8-row band gets the exact range
[lo, hi) of the chunks whose integer y-range, padded by ``MARGIN`` = 1 px,
meets it. The chunk boxes are exact per chunk (the JAX package groups them
in pairs above 2,048 chunks, an SMEM limit of the TPU). Padding faces are
the -1e9 degenerate sentinel, sorted last. A face that lies far off the
image (an absent occluder moved by +1e5 px) falls out through the band
ranges.

Finer than the JAX package, the kernel evaluates a (face, pixel) pair only
when the pixel centre lies in the face's float box padded by ``MARGIN``
(the Pallas kernel's per-tile test of the chunk boxes is implied by it);
the box, the edge vectors and the depths are one 20-float record per face,
computed once per call (:func:`face_records`). The header of
``csrc/zbuffer.cu`` argues why that pad drops no covered pair, and for
which faces it cannot.

Per pixel the result is the covering face of least z, ties to the smallest
sorted face id, its id in the sorted order (-1 where no face covers the
pixel) and its barycentrics w0, w1 (w2 = 1 − w0 − w1). A pair whose depth
is NaN covers nothing, and one at +inf never wins. The attribute gather
and interpolation stay in PyTorch, outside the kernel
(:func:`rasterize_attributes_fast`), so one kernel serves every attribute
width. Not differentiable.

:func:`zbuffer_bary` takes CPU tensors to :func:`rasterize_bary_plain`
(dense over all faces, so it also checks the pruning) and CUDA tensors to
the kernel, and raises on anything else. :func:`rasterize_bary_pruned`
mirrors the kernel's algorithm in PyTorch: the pairs inside the boxes, the
64-bit (z, id) key minimum and the per-pixel resolve.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from soccerplayershapepose_torch.render.band_raster import (
    BAND_H, CHUNK, SENTINEL, _band_chunk_bounds, _check, _check_count, _ptr,
    _stream, chunk_ranges, face_boxes, pixel_span)

# The margin of the bands' chunk ranges and the face-box pad, in px.
MARGIN = 1.0
# K3's tiles: one band of BAND_H rows by TILE_W columns.
TILE_W = 128
# Floats per face record of face_records: vertices 6, depths 3, edge
# vectors 6, one unused, padded box 4 (x0, x1, y0, y1).
REC = 20
BOX = slice(16, 20)
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
    last. NaN coordinates take no part in the chunk boxes
    (:func:`band_raster.chunk_ranges`).
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
    cymin, cymax = chunk_ranges(tri9[..., 1:6:2], CHUNK)
    cxmin, cxmax = chunk_ranges(tri9[..., 0:6:2], CHUNK)
    return tri9.contiguous(), order, cymin, cymax, cxmin, cxmax, n_chunks


def face_records(tri9: torch.Tensor) -> torch.Tensor:
    """(B, F_pad, 20) f32 face records from the sorted table (B, F_pad, 9):
    ``[x0 y0 x1 y1 x2 y2 | z0 z1 z2 | dx0 dy0 dx1 dy1 dx2 dy2 | 0 |
    bx0 bx1 by0 by1]``: edge e runs from vertex (e + 1) % 3 to (e + 2) % 3,
    each component one rounded difference as the plain version's per-pair
    xb − xa, and the face's float box is padded by ``MARGIN``. Sentinel
    faces get boxes far off the image, a face with a NaN vertex a NaN box:
    neither holds a pixel."""
    x, y = tri9[..., 0:6:2], tri9[..., 1:6:2]
    dx = torch.roll(x, -2, dims=-1) - torch.roll(x, -1, dims=-1)
    dy = torch.roll(y, -2, dims=-1) - torch.roll(y, -1, dims=-1)
    return torch.cat([tri9, torch.stack([dx, dy], -1).flatten(-2),
                      torch.zeros_like(tri9[..., :1]),
                      face_boxes(tri9[..., :6], MARGIN)], -1).contiguous()


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
    the kernel's: least z, then smallest sorted id. A pair whose z is NaN
    is dropped, as the kernel drops it, and +inf never wins.
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
        # A NaN depth covers nothing (amin would let it void the step).
        z = torch.where(inside & ~torch.isnan(z), z, float("inf"))

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
# The kernel's algorithm in PyTorch (pruned scatter, key minimum, resolve)
# ---------------------------------------------------------------------------

_EMPTY = torch.iinfo(torch.int64).max
# Faces per step of the mirror, to bound its per-pair tensors.
_MIRROR_FACES_PER_STEP = 4096


def box_pairs(boxes: torch.Tensor, img_wh: int):
    """The (face, pixel) pairs whose pixel centre lies in the face's box,
    boxes (N, 4) [x0, x1, y0, y1]: ``(face, px, py)``, each (M,) int64,
    face by face and row by row; M is :func:`band_raster.support_pairs` of
    the boxes."""
    x0, x1, y0, y1 = boxes.unbind(-1)
    fx, nx = pixel_span(x0, x1, img_wh)
    fy, ny = pixel_span(y0, y1, img_wh)
    n = nx * ny
    face = torch.repeat_interleave(torch.arange(n.numel(), device=n.device),
                                   n)
    i = torch.arange(face.numel(), device=n.device) - (
        torch.cumsum(n, 0) - n)[face]
    w = nx[face]
    return face, fx[face] + i % w, fy[face] + i // w


def _pair_bary(r: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """Per pair (records ``r`` (M, 20), pixel centres (M,) f32): the inside
    mask, w0, w1 (zero where not inside) and z, with the kernel's steps."""
    x, y, z3 = r[:, 0:6:2], r[:, 1:6:2], r[:, 6:9]
    dx, dy = r[:, 9:15:2], r[:, 10:15:2]
    a = (1, 2, 0)                 # edge e starts at vertex (e + 1) % 3
    e0, e1, e2 = (dx[:, k] * (py - y[:, a[k]]) - dy[:, k] * (px - x[:, a[k]])
                  for k in range(3))
    area = e0 + e1 + e2
    inside = (((e0 >= 0) & (e1 >= 0) & (e2 >= 0))
              | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))) & (torch.abs(area) > 1e-9)
    inv_area = 1.0 / torch.where(inside, area, 1.0)
    w0 = torch.where(inside, e0 * inv_area, 0.0)
    w1 = torch.where(inside, e1 * inv_area, 0.0)
    z = w0 * z3[:, 0] + w1 * z3[:, 1] + (1.0 - w0 - w1) * z3[:, 2]
    return inside, w0, w1, z


def zkey(z: torch.Tensor, fid: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (z, fid): the order-preserving bits of z (−0.0
    taken as +0.0) above the sorted face id. z must not be NaN."""
    bits = torch.where(z == 0, 0.0, z).view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (ordered.to(torch.int64) << 32) | fid.to(torch.int64)


def rasterize_bary_pruned(zr: torch.Tensor, img_wh: int):
    """What K3 does, step by step in PyTorch, from the face records ``zr``
    (B, F_pad, 20): every pair inside a face's padded box that passes the
    inside test with a z below +inf scatters its (z, id) key into its
    pixel with ``scatter_reduce(..., "amin")``; each pixel then decodes its
    key and recomputes the winner's w0, w1. Returns ``(fid, w0, w1)`` as
    :func:`rasterize_bary_plain`, which it equals wherever the pruning
    drops no covered pair."""
    b, f, _ = zr.shape
    p = img_wh * img_wh
    flat = zr.reshape(b * f, REC)
    keys = torch.full((b * p,), _EMPTY, dtype=torch.int64, device=zr.device)
    for s in range(0, b * f, _MIRROR_FACES_PER_STEP):
        face, px, py = box_pairs(flat[s:s + _MIRROR_FACES_PER_STEP, BOX],
                                 img_wh)
        face = face + s
        inside, _, _, z = _pair_bary(flat[face], px.float(), py.float())
        ok = inside & (z < float("inf"))
        pix = (face // f) * p + py * img_wh + px
        keys.scatter_reduce_(0, pix[ok], zkey(z[ok], face[ok] % f), "amin")
    hit = keys != _EMPTY
    pix = torch.nonzero(hit)[:, 0]
    sid = keys[hit] & 0xFFFFFFFF
    _, w0_hit, w1_hit, _ = _pair_bary(
        flat[(pix // p) * f + sid], (pix % img_wh).float(),
        ((pix % p) // img_wh).float())
    fid = torch.full((b * p,), -1, dtype=torch.int32, device=zr.device)
    w0 = torch.zeros((b * p,), device=zr.device)
    w1 = torch.zeros((b * p,), device=zr.device)
    fid[hit] = sid.to(torch.int32)
    w0[hit] = w0_hit
    w1[hit] = w1_hit
    shape = (b, img_wh, img_wh)
    return fid.reshape(shape), w0.reshape(shape), w1.reshape(shape)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _check_inputs(zr, lo, hi, img_wh, pair_count):
    if not isinstance(zr, torch.Tensor) or zr.dim() != 3 \
            or zr.shape[-1] != REC:
        raise ValueError(f"zr must be a (B, F_pad, {REC}) tensor of face "
                         "records")
    if zr.device.type != "cuda":
        raise ValueError(
            f"the z-buffer kernel takes CUDA tensors, got {zr.device}")
    b, f_pad, _ = zr.shape
    if f_pad < CHUNK or f_pad % CHUNK:
        raise ValueError(f"F_pad must be a multiple of {CHUNK}")
    dev = zr.device
    _check(zr, "zr", torch.float32, (b, f_pad, REC), dev)
    if zr.data_ptr() % 16:
        raise ValueError("zr must be 16-byte aligned (the kernel reads "
                         "float4)")
    n_bands = -(-img_wh // BAND_H)
    _check(lo, "lo", torch.int32, (b, n_bands), dev)
    _check(hi, "hi", torch.int32, (b, n_bands), dev)
    _check_count(pair_count, dev)
    return b, f_pad // CHUNK


def launch_zbuffer(zr, lo, hi, img_wh: int,
                   pair_count: Optional[torch.Tensor] = None):
    """Launch K3 on CUDA tensors: the face records ``zr`` of
    :func:`face_records` and the bands' chunk ranges ``lo``, ``hi``;
    anything else raises. Returns ``(fid int32, w0, w1 f32)``, each
    (B, wh, wh). With ``pair_count`` (a (1,) int64 tensor) the kernel adds
    the pairs it evaluated there."""
    from soccerplayershapepose_torch._build import load_library
    b, n_chunks = _check_inputs(zr, lo, hi, img_wh, pair_count)
    shape = (b, img_wh, img_wh)
    fid = torch.empty(shape, dtype=torch.int32, device=zr.device)
    w0 = torch.empty(shape, dtype=torch.float32, device=zr.device)
    w1 = torch.empty(shape, dtype=torch.float32, device=zr.device)
    lib = load_library()
    with torch.cuda.device(zr.device):
        rc = lib.spt_zbuffer_bary(
            _ptr(zr), _ptr(lo), _ptr(hi), _ptr(fid), _ptr(w0), _ptr(w1),
            _ptr(pair_count), b, n_chunks, CHUNK, img_wh, BAND_H, TILE_W,
            _stream(zr.device))
    if rc != 0:
        raise RuntimeError(f"zbuffer_bary launch failed: CUDA error {rc}")
    LAUNCHES["zbuffer_bary"] += 1
    return fid, w0, w1


def kernel_resources() -> dict:
    """Registers per thread, static shared bytes per block, local (spill)
    bytes per thread, resident blocks per SM and threads per block of K3 as
    the card loaded it."""
    from soccerplayershapepose_torch._build import load_library
    out = (ctypes.c_int * 5)()
    rc = load_library().spt_zbuffer_resources(out)
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {rc}")
    keys = ("regs", "shared_bytes", "local_bytes", "blocks_per_sm",
            "threads_per_block")
    return {"zbuffer_bary": dict(zip(keys, out))}


def zbuffer_bary(tri9, lo, hi, img_wh: int):
    """K3: ``(fid, w0, w1)`` from the sorted table and its bands' chunk
    ranges. CPU tensors take :func:`rasterize_bary_plain`; CUDA tensors get
    their face records and launch the kernel."""
    if tri9.device.type == "cpu":
        return rasterize_bary_plain(tri9, img_wh)
    return launch_zbuffer(face_records(tri9), lo, hi, img_wh)


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
    tri9, order, cymin, cymax, _, _, _ = _sorted_tri_z_and_ranges(
        verts2d, verts_z, faces)
    lo, hi = _band_chunk_bounds(cymin, cymax, -(-img_wh // BAND_H), BAND_H,
                                MARGIN)
    fid, w0, w1 = zbuffer_bary(tri9, lo, hi, img_wh)
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
