"""Banded soft-silhouette rasterizer: host glue, kernel wrappers, autograd.

Counterpart of ``soccerplayershapepose_tpu/render/pallas_raster.py``. The two
Pallas kernels there become CUDA C++ kernels in ``csrc/band_raster.cu``:

* K1 ``band_raster_fwd`` replaces ``_band_kernel`` (forward silhouette);
* K2 ``band_raster_bwd`` replaces ``_band_bwd_kernel`` (dL/d triangle).

The coarse pruning is the JAX package's: faces are y-sorted here, outside
the kernels; each (batch, band) gets the exact candidate-chunk range
[lo, hi) from the suffix-min / prefix-max of the chunk y-ranges; inside it
a chunk whose bounding box, padded by :func:`support_margin`, misses the
block's tile is skipped. Back faces are culled by overwriting them with the
-1e9 degenerate sentinel, which sorts last and lies in no band's range.

Finer than the JAX package, both kernels evaluate a (face, pixel) pair
only when the pixel centre lies in the face's bounding box padded by
:func:`support_radius`, outside which the coverage is below 2e-9. The
box, the edges, their reciprocal squared lengths and the non-degenerate
flag are computed once per call here (:func:`face_constants`), as one
20-float record per face that both kernels read.

Each wrapper takes CPU tensors to its plain PyTorch version below (dense
over all faces, so it also checks the pruning) and CUDA tensors to the
kernel, and raises on anything else. K1's blocks are ``BAND_H × TILE_W`` =
8 × 32 pixels over ``CHUNK`` = 8 faces per chunk; K2 runs one thread per
face.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Iterator, Optional

import torch

from soccerplayershapepose_torch.render.softras import D_MAX, pixel_grid
from soccerplayershapepose_torch.utils import profiling

BAND_H = 8
TILE_W = 32
CHUNK = 8
SENTINEL = -1e9
# Floats per face record of face_constants: vertices 6, edges 6, 1/|e|² 3,
# nondeg 1, padded box 4 (x0, x1, y0, y1).
REC = 20
BOX = slice(16, 20)

# Launches of each kernel since the last reset_launch_counts(); a wrapper
# adds one where it launches its kernel and nowhere else, and a replay of a
# CUDA graph adds the launches the graph holds (graph_launches).
LAUNCHES = {"band_raster_fwd": 0, "band_raster_bwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def graph_launches() -> Iterator[dict]:
    """Around the capture of a CUDA graph, which records launches and runs
    none: the block's launches leave ``LAUNCHES`` and go to the dict it
    yields, the launches each replay makes (:func:`add_launches`)."""
    before = dict(LAUNCHES)
    held = {}
    try:
        yield held
    finally:
        for k in LAUNCHES:
            held[k] = LAUNCHES[k] - before[k]
            LAUNCHES[k] = before[k]


def add_launches(held: dict) -> None:
    """Count a replay of a graph that holds ``held`` launches."""
    for k, n in held.items():
        LAUNCHES[k] += n


# Support of a face in units of σ_px: beyond d² = 20.1·σ_px the coverage
# sigmoid(−d²/σ_px) is below 1.9e-9, under 2e-9 with room for the rounding
# of d² (20·σ_px would give 2.06e-9).
SUPPORT_D2 = 20.1


def support_radius(sigma_px: float) -> float:
    """Face-box padding in px, √(20.1·σ_px): a pixel centre outside a face's
    box so padded has coverage D < 2e-9 from that face."""
    return (SUPPORT_D2 * sigma_px) ** 0.5


def support_margin(sigma_px: float) -> float:
    """Chunk-box padding in px: the support radius plus 2 px for the integer
    rounding of the chunk boxes."""
    return support_radius(sigma_px) + 2.0


def inv_sigma_f32(sigma_px: float) -> float:
    """1/σ_px rounded to float32, the factor both the kernels and the plain
    versions multiply by."""
    return torch.tensor(1.0 / sigma_px, dtype=torch.float32).item()


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
    cymin, cymax = chunk_ranges(tri[..., 1::2], chunk)
    cxmin, cxmax = chunk_ranges(tri[..., 0::2], chunk)
    return tri.contiguous(), order, cymin, cymax, cxmin, cxmax, n_chunks


def chunk_ranges(coords: torch.Tensor, chunk: int):
    """(B, n_chunks) int32 (floor of the least, ceil of the largest) of the
    coordinates (B, F_pad, 3) of each chunk of ``chunk`` faces. Sentinel
    faces and NaN coordinates take no part, so a NaN vertex cannot void its
    chunk's box; a chunk with no other coordinate gets (1e9, -1e9), which
    meets no band and no tile."""
    b, f_pad, _ = coords.shape
    skip = (coords[..., :1] < -1e8) | torch.isnan(coords)
    lo = torch.where(skip, torch.full_like(coords, 1e9), coords)
    hi = torch.where(skip, torch.full_like(coords, -1e9), coords)
    lo = torch.amin(lo.reshape(b, f_pad // chunk, chunk * 3), dim=-1)
    hi = torch.amax(hi.reshape(b, f_pad // chunk, chunk * 3), dim=-1)
    return (torch.floor(lo).to(torch.int32).contiguous(),
            torch.ceil(hi).to(torch.int32).contiguous())


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


def face_boxes(tri: torch.Tensor, radius: float) -> torch.Tensor:
    """(..., 4) [x0, x1, y0, y1]: the float bounding box of each triangle of
    ``tri`` (..., 6), padded by ``radius`` px."""
    x, y = tri[..., 0::2], tri[..., 1::2]
    return torch.stack([torch.amin(x, -1) - radius, torch.amax(x, -1) + radius,
                        torch.amin(y, -1) - radius, torch.amax(y, -1) + radius],
                       -1)


def face_constants(tri: torch.Tensor, radius: float) -> torch.Tensor:
    """(B, F_pad, 20) f32 face records from sorted triangles (B, F_pad, 6):
    ``[ax ay bx by cx cy | ex0 ey0 ex1 ey1 ex2 ey2 | iee0 iee1 iee2 nondeg |
    x0 x1 y0 y1]``: the edges a→b, b→c, c→a, 1/max(|e|², 1e-12), the
    non-degenerate flag (|signed area| > 1e-9) and the box padded by
    ``radius``. Sentinel faces get boxes far off the image."""
    b, f, _ = tri.shape
    v = tri.reshape(b, f, 3, 2)
    e = torch.roll(v, -1, dims=2) - v
    iee = 1.0 / torch.clamp(e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1],
                            min=1e-12)
    ax, ay, bx, by, cx, cy = tri.unbind(-1)
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    nondeg = (torch.abs(area) > 1e-9).to(tri.dtype)[..., None]
    return torch.cat([tri, e.reshape(b, f, 6), iee, nondeg,
                      face_boxes(tri, radius)], -1).contiguous()


def pixel_span(lo: torch.Tensor, hi: torch.Tensor, img_wh: int):
    """``(first, count)`` int64 of the pixel indices in [0, img_wh) whose
    centre lies in [lo, hi]; count 0 where that is none or a side is NaN,
    as in the kernels."""
    first = torch.clamp(torch.ceil(lo), min=0.0)
    last = torch.clamp(torch.floor(hi), max=float(img_wh - 1))
    n = torch.clamp(last - first + 1.0, min=0.0)
    n = torch.where(lo <= hi, n, torch.zeros_like(n)).to(torch.int64)
    return torch.nan_to_num(first).to(torch.int64), n


def support_pairs(boxes: torch.Tensor, img_wh: int) -> int:
    """Number of (face, pixel) pairs whose pixel centre (integer x, y in
    [0, img_wh)) lies in the face's box, boxes (..., 4) [x0, x1, y0, y1]. A
    box with a NaN side holds none, as in the kernels."""
    x0, x1, y0, y1 = boxes.unbind(-1)
    return int((pixel_span(x0, x1, img_wh)[1]
                * pixel_span(y0, y1, img_wh)[1]).sum())


# ---------------------------------------------------------------------------
# Plain versions of the kernels (dense over every face; the CPU path)
# ---------------------------------------------------------------------------

def pair_terms(fc: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    """Per (face, pixel) terms from face records ``fc`` (B, C, 20) and pixel
    centres (P,): per edge ``(cross, d2, t, rx, ry)``, each (B, C, P), the
    inside mask (either winding, degenerate faces never inside) and
    ``nondeg`` (B, C, 1). The projection multiplies by the record's
    1/|e|², as the kernels do."""
    def col(i):
        return fc[..., i:i + 1]

    edges = []
    for k in range(3):
        ex, ey = col(6 + 2 * k), col(7 + 2 * k)
        pxr = px - col(2 * k)
        pyr = py - col(2 * k + 1)
        cross = ex * pyr - ey * pxr
        t = torch.clamp((pxr * ex + pyr * ey) * col(12 + k), 0.0, 1.0)
        rx = pxr - t * ex
        ry = pyr - t * ey
        edges.append((cross, rx * rx + ry * ry, t, rx, ry))
    nondeg = col(15)
    c0, c1, c2 = (e[0] for e in edges)
    inside = (((c0 >= 0) & (c1 >= 0) & (c2 >= 0))
              | ((c0 <= 0) & (c1 <= 0) & (c2 <= 0))) & (nondeg > 0)
    return edges, inside, nondeg


def pair_coverage(fc: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                  inv_sigma: float) -> torch.Tensor:
    """(B, C, P) clamped soft coverage D of every (face, pixel) pair."""
    (e0, e1, e2), inside, _ = pair_terms(fc, px, py)
    d2min = torch.minimum(e0[1], torch.minimum(e1[1], e2[1]))
    signed = torch.where(inside, d2min, -d2min)
    return torch.clamp(torch.sigmoid(signed * inv_sigma), max=D_MAX)


def band_raster_fwd_plain(fc: torch.Tensor, img_wh: int, sigma_px: float,
                          faces_per_chunk: int = 86) -> torch.Tensor:
    """What K1 computes, over every (face, pixel) pair: (B, wh, wh)."""
    b, f_pad, _ = fc.shape
    px, py = pixel_grid(img_wh, fc.device)
    inv_sigma = inv_sigma_f32(sigma_px)
    acc = torch.zeros((b, img_wh * img_wh), dtype=torch.float32,
                      device=fc.device)
    for s in range(0, f_pad, faces_per_chunk):
        d = pair_coverage(fc[:, s:s + faces_per_chunk], px, py, inv_sigma)
        acc = acc + torch.sum(torch.log1p(-d), dim=1)
    return (1.0 - torch.exp(acc)).reshape(b, img_wh, img_wh)


def band_raster_bwd_plain(fc: torch.Tensor, gs: torch.Tensor, img_wh: int,
                          sigma_px: float,
                          faces_per_chunk: int = 86) -> torch.Tensor:
    """What K2 computes, over every (face, pixel) pair: dtri (B, F_pad, 6).

    ``gs`` (B, wh, wh) is g·(1−S). Per (face, pixel) dL/d(d²_min) is
    ``gs·D·(1/σ)·sign·nondeg``; the minimum edge (ties to the lower edge, so
    a shared vertex is counted once) passes −2r(1−t) and −2rt to its
    endpoints (envelope theorem on the clamped projection).
    """
    b, f_pad, _ = fc.shape
    px, py = pixel_grid(img_wh, fc.device)
    inv_sigma = inv_sigma_f32(sigma_px)
    g = gs.reshape(b, 1, img_wh * img_wh)
    out = []
    for s in range(0, f_pad, faces_per_chunk):
        (e0, e1, e2), inside, nondeg = pair_terms(
            fc[:, s:s + faces_per_chunk], px, py)
        _, d0, t0, rx0, ry0 = e0
        _, d1, t1, rx1, ry1 = e1
        _, d2, t2, rx2, ry2 = e2
        d2min = torch.minimum(d0, torch.minimum(d1, d2))
        signed = torch.where(inside, d2min, -d2min)
        dcov = torch.clamp(torch.sigmoid(signed * inv_sigma), max=D_MAX)
        sign = torch.where(inside, 1.0, -1.0)
        gd2 = g * dcov * inv_sigma * sign * nondeg
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


def _check_fc(fc) -> None:
    if not isinstance(fc, torch.Tensor) or fc.dim() != 3 \
            or fc.shape[-1] != REC:
        raise ValueError(f"fc must be a (B, F_pad, {REC}) tensor")
    if fc.device.type != "cuda":
        raise ValueError(f"the band kernels take CUDA tensors, got {fc.device}")
    _check(fc, "fc", torch.float32, tuple(fc.shape), fc.device)
    if fc.data_ptr() % 16:
        raise ValueError("fc must be 16-byte aligned (the kernels read "
                         "float4)")


def _check_count(pair_count: Optional[torch.Tensor], device) -> None:
    if pair_count is not None:
        _check(pair_count, "pair_count", torch.int64, (1,), device)


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else None)


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def launch_fwd(fc, cymin, cymax, cxmin, cxmax, lo, hi, img_wh: int,
               sigma_px: float, margin: float,
               pair_count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K1 on CUDA tensors; anything else raises. With ``pair_count``
    (a (1,) int64 tensor) the kernel adds the pairs it evaluated there."""
    from soccerplayershapepose_torch._build import load_library
    _check_fc(fc)
    b, f_pad, _ = fc.shape
    n_chunks = cymin.shape[-1] if isinstance(cymin, torch.Tensor) \
        and cymin.dim() == 2 else -1
    if n_chunks <= 0 or f_pad % n_chunks:
        raise ValueError("F_pad must be n_chunks · chunk")
    n_bands = -(-img_wh // BAND_H)
    dev = fc.device
    for name, t in (("cymin", cymin), ("cymax", cymax), ("cxmin", cxmin),
                    ("cxmax", cxmax)):
        _check(t, name, torch.int32, (b, n_chunks), dev)
    _check(lo, "lo", torch.int32, (b, n_bands), dev)
    _check(hi, "hi", torch.int32, (b, n_bands), dev)
    _check_count(pair_count, dev)
    out = torch.empty((b, img_wh, img_wh), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.spt_band_raster_fwd(
            _ptr(fc), _ptr(cymin), _ptr(cymax), _ptr(cxmin), _ptr(cxmax),
            _ptr(lo), _ptr(hi), _ptr(out), _ptr(pair_count), b, n_chunks,
            f_pad // n_chunks, img_wh, BAND_H, TILE_W,
            inv_sigma_f32(sigma_px), float(margin), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"band_raster_fwd launch failed: CUDA error {rc}")
    LAUNCHES["band_raster_fwd"] += 1
    return out


def launch_bwd(fc, gs, img_wh: int, sigma_px: float,
               pair_count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K2 on CUDA tensors; anything else raises. With ``pair_count``
    (a (1,) int64 tensor) the kernel adds the pairs it evaluated there."""
    from soccerplayershapepose_torch._build import load_library
    _check_fc(fc)
    b, f_pad, _ = fc.shape
    dev = fc.device
    _check(gs, "gs", torch.float32, (b, img_wh, img_wh), dev)
    _check_count(pair_count, dev)
    # K2 writes every face's six values, so no zero fill is needed.
    dtri = torch.empty((b, f_pad, 6), dtype=torch.float32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        rc = lib.spt_band_raster_bwd(
            _ptr(fc), _ptr(gs), _ptr(dtri), _ptr(pair_count), b, f_pad,
            img_wh, inv_sigma_f32(sigma_px), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"band_raster_bwd launch failed: CUDA error {rc}")
    LAUNCHES["band_raster_bwd"] += 1
    return dtri


def kernel_resources() -> dict:
    """Registers per thread, static shared bytes per block, local (spill)
    bytes per thread, resident blocks per SM and threads per block of K1
    and K2 as the card loaded them."""
    from soccerplayershapepose_torch._build import load_library
    out = (ctypes.c_int * 10)()
    rc = load_library().spt_band_raster_resources(out)
    if rc != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {rc}")
    keys = ("regs", "shared_bytes", "local_bytes", "blocks_per_sm",
            "threads_per_block")
    return {name: dict(zip(keys, out[5 * i:5 * i + 5]))
            for i, name in enumerate(("band_raster_fwd", "band_raster_bwd"))}


def band_raster_fwd(fc, cymin, cymax, cxmin, cxmax, lo, hi, img_wh: int,
                    sigma_px: float, margin: float) -> torch.Tensor:
    """K1: (B, wh, wh) silhouette from the sorted faces' records and their
    ranges. CPU tensors take :func:`band_raster_fwd_plain`."""
    if fc.device.type == "cpu":
        return band_raster_fwd_plain(fc, img_wh, sigma_px)
    return launch_fwd(fc, cymin, cymax, cxmin, cxmax, lo, hi, img_wh,
                      sigma_px, margin)


def band_raster_bwd(fc, gs, img_wh: int, sigma_px: float) -> torch.Tensor:
    """K2: dtri (B, F_pad, 6) in sorted order from gs = g·(1−S).
    CPU tensors take :func:`band_raster_bwd_plain`."""
    if fc.device.type == "cpu":
        return band_raster_bwd_plain(fc, gs, img_wh, sigma_px)
    return launch_bwd(fc, gs, img_wh, sigma_px)


def band_inputs(verts2d: torch.Tensor, faces: torch.Tensor, img_wh: int,
                sigma_px: float, backface_cull: bool):
    """What K1 and K2 take: ``(fc, cymin, cymax, cxmin, cxmax, lo, hi)``,
    and the sort ``order`` (B, F) to undo afterwards."""
    margin = support_margin(sigma_px)
    tri, order, cymin, cymax, cxmin, cxmax, _ = _sorted_tri_and_ranges(
        verts2d, faces, CHUNK, backface_cull)
    lo, hi = _band_chunk_bounds(cymin, cymax, -(-img_wh // BAND_H), BAND_H,
                                margin)
    fc = face_constants(tri, support_radius(sigma_px))
    return (fc, cymin, cymax, cxmin, cxmax, lo, hi), order


class SoftSilhouetteBand(torch.autograd.Function):
    """Soft silhouette through K1 forward and K2 backward.

    The sort, cull, chunk ranges and face records are computed once in
    forward and the records saved for backward (the role of
    ``soft_silhouette_fast``'s residuals). The un-sort and the scatter onto
    vertices stay in torch. Forward is the span ``raster.fwd`` and
    backward ``raster.bwd`` (``utils/profiling.py``).
    """

    @staticmethod
    def forward(ctx, verts2d, faces, img_wh, sigma, backface_cull):
        with profiling.span("raster.fwd"):
            sigma_px = float(sigma) * (img_wh / 2.0) ** 2
            args, order = band_inputs(verts2d.detach(), faces, img_wh,
                                      sigma_px, backface_cull)
            s = band_raster_fwd(*args, img_wh, sigma_px,
                                support_margin(sigma_px))
            ctx.save_for_backward(args[0], order, s, faces)
            ctx.meta = (img_wh, sigma_px, verts2d.shape[1])
            return s

    @staticmethod
    def backward(ctx, g):
        with profiling.span("raster.bwd"):
            fc, order, s, faces = ctx.saved_tensors
            img_wh, sigma_px, n_verts = ctx.meta
            gs = (g * (1.0 - s)).to(torch.float32).contiguous()
            dtri_sorted = band_raster_bwd(fc, gs, img_wh, sigma_px)
            b, f = order.shape
            dtri = torch.zeros((b, f, 6), dtype=torch.float32,
                               device=fc.device)
            dtri.scatter_(1, order[..., None].expand(-1, -1, 6),
                          dtri_sorted[:, :f])
            dverts = torch.zeros((b, n_verts, 2), dtype=torch.float32,
                                 device=fc.device)
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
