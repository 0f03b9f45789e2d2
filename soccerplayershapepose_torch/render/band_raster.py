"""Banded soft-silhouette rasterizer: host glue, kernel wrappers, autograd.

Counterpart of ``soccerplayershapepose_tpu/render/pallas_raster.py``. The two
Pallas kernels there become CUDA C++ kernels in ``csrc/band_raster.cu``:

* K1 ``band_raster_fwd`` replaces ``_band_kernel`` (forward silhouette);
* K2 ``band_raster_bwd`` replaces ``_band_bwd_kernel`` (dL/d triangle).

The pruning is the JAX package's: faces are y-sorted here, outside the
kernels; each (batch, band) gets the exact candidate-chunk range [lo, hi)
from the suffix-min / prefix-max of the chunk y-ranges; inside it a chunk
whose bounding box, padded by the sigmoid support margin, misses the block's
tile is skipped. Back faces are culled by overwriting them with the -1e9
degenerate sentinel, which sorts last and lies in no band's range.

Each wrapper takes CPU tensors to its plain PyTorch version below (dense
over all faces, so it also checks the pruning) and CUDA tensors to the
kernel, and raises on anything else. The kernels' blocks are
``BAND_H × TILE_W`` = 8 × 32 pixels (256 threads, one per pixel) over
``CHUNK`` = 8 faces per chunk.
"""

from __future__ import annotations

import ctypes

import torch

from soccerplayershapepose_torch.render.softras import (
    D_MAX, pixel_grid, point_triangle_coverage, triangle_terms)

BAND_H = 8
TILE_W = 32
CHUNK = 8
SENTINEL = -1e9

# Launches of each kernel since the last reset_launch_counts(); a wrapper
# adds one where it launches its kernel and nowhere else.
LAUNCHES = {"band_raster_fwd": 0, "band_raster_bwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def support_margin(sigma_px: float) -> float:
    """Band-test padding in px: sigmoid(−d²/σ) < 2e-9 once d² > 20σ, plus
    2 px for the integer rounding of the chunk boxes."""
    return (20.0 * sigma_px) ** 0.5 + 2.0


# ---------------------------------------------------------------------------
# Host glue (torch, on the tensors' device)
# ---------------------------------------------------------------------------

def _sorted_tri_and_ranges(verts2d: torch.Tensor, faces: torch.Tensor,
                           chunk: int = CHUNK, backface_cull: bool = False):
    """y-sorted, sentinel-padded triangles and integer chunk boxes.

    Returns ``(tri (B, F_pad, 6) f32, order (B, F) int64, cymin, cymax,
    cxmin, cxmax (B, n_chunks) int32, n_chunks)``. With ``backface_cull``
    the faces below the k-th largest signed area (k = 0.6·F, the keep set
    of ``softras.cull_backfaces``) become sentinels.
    """
    b = verts2d.shape[0]
    f = faces.shape[0]
    tri = verts2d[:, faces.to(torch.long)].reshape(b, f, 6)
    if backface_cull:
        ax, ay, bx, by, cx, cy = tri.unbind(-1)
        area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
        k = max(1, int(f * 0.6))
        thresh = torch.topk(area, k, dim=1).values[:, -1:]
        tri = torch.where((area >= thresh)[..., None], tri,
                          torch.full_like(tri, SENTINEL))
    ymin_f = torch.amin(tri[..., 1::2], dim=-1)
    key = torch.where(ymin_f < -1e8, torch.full_like(ymin_f, 3e7), ymin_f)
    # jnp.argsort is stable; torch's default is not.
    order = torch.argsort(key, dim=-1, stable=True)
    tri = torch.gather(tri, 1, order[..., None].expand(-1, -1, 6))
    n_chunks = -(-f // chunk)
    pad = n_chunks * chunk - f
    if pad:
        tri = torch.cat([tri, tri.new_full((b, pad, 6), SENTINEL)], dim=1)

    def ranges(coords):
        sent = (coords[..., 0] < -1e8)[..., None]
        lo = torch.where(sent, torch.full_like(coords, 1e9), coords)
        hi = torch.where(sent, torch.full_like(coords, -1e9), coords)
        lo = torch.amin(lo.reshape(b, n_chunks, chunk * 3), dim=-1)
        hi = torch.amax(hi.reshape(b, n_chunks, chunk * 3), dim=-1)
        return (torch.floor(lo).to(torch.int32).contiguous(),
                torch.ceil(hi).to(torch.int32).contiguous())

    cymin, cymax = ranges(tri[..., 1::2])
    cxmin, cxmax = ranges(tri[..., 0::2])
    return tri.contiguous(), order, cymin, cymax, cxmin, cxmax, n_chunks


def _band_chunk_bounds(cymin: torch.Tensor, cymax: torch.Tensor,
                       n_bands: int, band_h: int, margin: float):
    """(B, n_bands) int32 [lo, hi) candidate-chunk bounds per band.

    Exact for any chunk order: the suffix-minimum of ``cymin`` and the
    prefix-maximum of ``cymax`` are monotone, so a binary search over them
    gives the tightest contiguous range outside which every chunk fails the
    band's y-overlap test.
    """
    b = cymin.shape[0]
    smin = torch.flip(torch.cummin(torch.flip(cymin.float(), [1]), 1).values,
                      [1]).contiguous()
    pmax = torch.cummax(cymax.float(), 1).values.contiguous()
    y0 = torch.arange(n_bands, dtype=torch.float32,
                      device=cymin.device) * band_h
    y1 = y0 + band_h
    hi = torch.searchsorted(smin, (y1 + margin).expand(b, n_bands).contiguous(),
                            right=True)
    lo = torch.searchsorted(pmax, (y0 - margin).expand(b, n_bands).contiguous(),
                            right=False)
    return lo.to(torch.int32).contiguous(), hi.to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# Plain versions of the kernels (dense over every face; the CPU path)
# ---------------------------------------------------------------------------

def band_raster_fwd_plain(tri: torch.Tensor, img_wh: int, sigma_px: float,
                          faces_per_chunk: int = 86) -> torch.Tensor:
    """What K1 computes, over every (face, pixel) pair: (B, wh, wh)."""
    b, f_pad, _ = tri.shape
    px, py = pixel_grid(img_wh, tri.device)
    acc = torch.zeros((b, img_wh * img_wh), dtype=torch.float32,
                      device=tri.device)
    for s in range(0, f_pad, faces_per_chunk):
        t = tri[:, s:s + faces_per_chunk].reshape(b, -1, 3, 2)
        d = torch.clamp(point_triangle_coverage(px, py, t, sigma_px), max=D_MAX)
        acc = acc + torch.sum(torch.log1p(-d), dim=1)
    return (1.0 - torch.exp(acc)).reshape(b, img_wh, img_wh)


def band_raster_bwd_plain(tri: torch.Tensor, gs: torch.Tensor, img_wh: int,
                          sigma_px: float,
                          faces_per_chunk: int = 86) -> torch.Tensor:
    """What K2 computes, over every (face, pixel) pair: dtri (B, F_pad, 6).

    ``gs`` (B, wh, wh) is g·(1−S). Per (face, pixel) dL/d(d²_min) is
    ``gs·D/σ·sign·nondeg``; the minimum edge (ties to the lower edge, so a
    shared vertex is counted once) passes −2r(1−t) and −2rt to its
    endpoints (envelope theorem on the clamped projection).
    """
    b, f_pad, _ = tri.shape
    px, py = pixel_grid(img_wh, tri.device)
    g = gs.reshape(b, 1, img_wh * img_wh)
    out = []
    for s in range(0, f_pad, faces_per_chunk):
        t6 = tri[:, s:s + faces_per_chunk].reshape(b, -1, 3, 2)
        (e0, e1, e2), inside, nondeg = triangle_terms(px, py, t6)
        _, d0, t0, rx0, ry0 = e0
        _, d1, t1, rx1, ry1 = e1
        _, d2, t2, rx2, ry2 = e2
        d2min = torch.minimum(d0, torch.minimum(d1, d2))
        signed = torch.where(inside, d2min, -d2min)
        dcov = torch.clamp(torch.sigmoid(signed / sigma_px), max=D_MAX)
        sign = torch.where(inside, 1.0, -1.0)
        gd2 = g * dcov / sigma_px * sign * nondeg
        min0 = (d0 <= d1) & (d0 <= d2)
        min1 = (d1 < d0) & (d1 <= d2)
        min2 = (d2 < d0) & (d2 < d1)
        ux0, uy0 = gd2 * min0 * rx0, gd2 * min0 * ry0
        ux1, uy1 = gd2 * min1 * rx1, gd2 * min1 * ry1
        ux2, uy2 = gd2 * min2 * rx2, gd2 * min2 * ry2
        vx0, vy0, vx1, vy1 = ux0 * t0, uy0 * t0, ux1 * t1, uy1 * t1
        vx2, vy2 = ux2 * t2, uy2 * t2
        g6 = torch.stack([vx0 - ux0 - vx2, vy0 - uy0 - vy2,
                          vx1 - ux1 - vx0, vy1 - uy1 - vy0,
                          vx2 - ux2 - vx1, vy2 - uy2 - vy1], dim=-1)
        out.append(2.0 * torch.sum(g6, dim=2))
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name} must lie on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(tri, cymin, cymax, cxmin, cxmax, lo, hi, img_wh):
    if not isinstance(tri, torch.Tensor) or tri.dim() != 3 \
            or tri.shape[-1] != 6:
        raise ValueError("tri must be a (B, F_pad, 6) tensor")
    if tri.device.type != "cuda":
        raise ValueError(f"the band kernels take CUDA tensors, got {tri.device}")
    b, f_pad, _ = tri.shape
    n_chunks = cymin.shape[-1] if cymin.dim() == 2 else -1
    if n_chunks <= 0 or f_pad % n_chunks:
        raise ValueError("F_pad must be n_chunks · chunk")
    chunk = f_pad // n_chunks
    n_bands = -(-img_wh // BAND_H)
    dev = tri.device
    _check(tri, "tri", torch.float32, (b, f_pad, 6), dev)
    for name, t in (("cymin", cymin), ("cymax", cymax), ("cxmin", cxmin),
                    ("cxmax", cxmax)):
        _check(t, name, torch.int32, (b, n_chunks), dev)
    _check(lo, "lo", torch.int32, (b, n_bands), dev)
    _check(hi, "hi", torch.int32, (b, n_bands), dev)
    return b, n_chunks, chunk


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch_fwd(tri, cymin, cymax, cxmin, cxmax, lo, hi, img_wh: int,
               sigma_px: float, margin: float) -> torch.Tensor:
    """Launch K1 on CUDA tensors; anything else raises."""
    from soccerplayershapepose_torch._build import load_library
    b, n_chunks, chunk = _check_inputs(tri, cymin, cymax, cxmin, cxmax, lo,
                                       hi, img_wh)
    out = torch.empty((b, img_wh, img_wh), dtype=torch.float32,
                      device=tri.device)
    lib = load_library()
    with torch.cuda.device(tri.device):
        rc = lib.spt_band_raster_fwd(
            _ptr(tri), _ptr(cymin), _ptr(cymax), _ptr(cxmin), _ptr(cxmax),
            _ptr(lo), _ptr(hi), _ptr(out), b, n_chunks, chunk, img_wh,
            BAND_H, TILE_W, float(sigma_px), float(margin),
            _stream(tri.device))
    if rc != 0:
        raise RuntimeError(f"band_raster_fwd launch failed: CUDA error {rc}")
    LAUNCHES["band_raster_fwd"] += 1
    return out


def launch_bwd(tri, cymin, cymax, cxmin, cxmax, lo, hi, gs, img_wh: int,
               sigma_px: float, margin: float) -> torch.Tensor:
    """Launch K2 on CUDA tensors; anything else raises."""
    from soccerplayershapepose_torch._build import load_library
    b, n_chunks, chunk = _check_inputs(tri, cymin, cymax, cxmin, cxmax, lo,
                                       hi, img_wh)
    _check(gs, "gs", torch.float32, (b, img_wh, img_wh), tri.device)
    dtri = torch.zeros_like(tri)
    lib = load_library()
    with torch.cuda.device(tri.device):
        rc = lib.spt_band_raster_bwd(
            _ptr(tri), _ptr(cymin), _ptr(cymax), _ptr(cxmin), _ptr(cxmax),
            _ptr(lo), _ptr(hi), _ptr(gs), _ptr(dtri), b, n_chunks, chunk,
            img_wh, BAND_H, TILE_W, float(sigma_px), float(margin),
            _stream(tri.device))
    if rc != 0:
        raise RuntimeError(f"band_raster_bwd launch failed: CUDA error {rc}")
    LAUNCHES["band_raster_bwd"] += 1
    return dtri


def band_raster_fwd(tri, cymin, cymax, cxmin, cxmax, lo, hi, img_wh: int,
                    sigma_px: float, margin: float) -> torch.Tensor:
    """K1: (B, wh, wh) silhouette from sorted triangles and their ranges.
    CPU tensors take :func:`band_raster_fwd_plain`."""
    if tri.device.type == "cpu":
        return band_raster_fwd_plain(tri, img_wh, sigma_px)
    return launch_fwd(tri, cymin, cymax, cxmin, cxmax, lo, hi, img_wh,
                      sigma_px, margin)


def band_raster_bwd(tri, cymin, cymax, cxmin, cxmax, lo, hi, gs,
                    img_wh: int, sigma_px: float,
                    margin: float) -> torch.Tensor:
    """K2: dtri (B, F_pad, 6) in sorted order from gs = g·(1−S).
    CPU tensors take :func:`band_raster_bwd_plain`."""
    if tri.device.type == "cpu":
        return band_raster_bwd_plain(tri, gs, img_wh, sigma_px)
    return launch_bwd(tri, cymin, cymax, cxmin, cxmax, lo, hi, gs, img_wh,
                      sigma_px, margin)


class SoftSilhouetteBand(torch.autograd.Function):
    """Soft silhouette through K1 forward and K2 backward.

    The sort, cull and chunk ranges are computed once in forward and saved
    for backward (the role of ``soft_silhouette_fast``'s residuals). The
    un-sort and the scatter onto vertices stay in torch.
    """

    @staticmethod
    def forward(ctx, verts2d, faces, img_wh, sigma, backface_cull):
        sigma_px = float(sigma) * (img_wh / 2.0) ** 2
        margin = support_margin(sigma_px)
        tri, order, cymin, cymax, cxmin, cxmax, _ = _sorted_tri_and_ranges(
            verts2d.detach(), faces, CHUNK, backface_cull)
        lo, hi = _band_chunk_bounds(cymin, cymax, -(-img_wh // BAND_H),
                                    BAND_H, margin)
        s = band_raster_fwd(tri, cymin, cymax, cxmin, cxmax, lo, hi, img_wh,
                            sigma_px, margin)
        ctx.save_for_backward(tri, order, cymin, cymax, cxmin, cxmax, lo, hi,
                              s, faces)
        ctx.meta = (img_wh, sigma_px, margin, verts2d.shape[1])
        return s

    @staticmethod
    def backward(ctx, g):
        tri, order, cymin, cymax, cxmin, cxmax, lo, hi, s, faces = \
            ctx.saved_tensors
        img_wh, sigma_px, margin, n_verts = ctx.meta
        gs = (g * (1.0 - s)).to(torch.float32).contiguous()
        dtri_sorted = band_raster_bwd(tri, cymin, cymax, cxmin, cxmax, lo, hi,
                                      gs, img_wh, sigma_px, margin)
        b, f = order.shape
        dtri = torch.zeros((b, f, 6), dtype=torch.float32, device=tri.device)
        dtri.scatter_(1, order[..., None].expand(-1, -1, 6),
                      dtri_sorted[:, :f])
        dverts = torch.zeros((b, n_verts, 2), dtype=torch.float32,
                             device=tri.device)
        dverts.index_add_(1, faces.reshape(-1).to(torch.long),
                          dtri.reshape(b, f * 3, 2))
        return dverts, None, None, None, None


def soft_silhouette_band(verts2d: torch.Tensor, faces: torch.Tensor,
                         img_wh: int, sigma: float = 1e-5,
                         backface_cull: bool = False) -> torch.Tensor:
    """(B, img_wh, img_wh) soft silhouette of (B, V, 2) pixel-space
    vertices through the banded kernels (plain versions on the CPU)."""
    return SoftSilhouetteBand.apply(verts2d, faces, img_wh, sigma,
                                    backface_cull)
