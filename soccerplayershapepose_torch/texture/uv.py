"""UV texture conversion: DensePose IUV → 24-part SMPL atlas → normal UV map.

Counterpart of ``soccerplayershapepose_tpu/texture/uv.py``:

* :func:`iuv_to_atlas_texture` scatters every pixel of an IUV-annotated
  image into part ``I``'s texture at (U, V) scaled to the per-part
  resolution (24 parts × 200²), as a mean per texel (one ``index_add_``
  for the sums and one for the counts; on the card these add with atomics,
  so a texel's sum may round in another order from run to run), and
  keeps the mask of written texels;
* :func:`fuse_atlas_textures` averages frames' atlases by their masks;
* :func:`concat_atlas` / :func:`split_atlas` convert between the 24 parts
  and a 4 × 6 tile sheet;
* :func:`atlas_to_normal` / :func:`normal_to_atlas` convert between the
  atlas and the single "normal" SMPL UV map, through a mapping pickle (this
  package's dense dict, or the reference's (K, 5) relation list) or the
  procedural 4 × 6 tiling when none is given; a relation list whose
  targets repeat leaves the winner unspecified, as in the JAX package;
* :func:`sample_uv_texture` is the bilinear lookup of the textured render.

The atlas functions take one image, as the JAX ones do, or a batch of
them on leading axes (the JAX package ``vmap``s them).
"""

from __future__ import annotations

import pickle
from typing import Optional, Tuple

import numpy as np
import torch

NUM_PARTS = 24
PART_RES = 200
GRID_ROWS, GRID_COLS = 4, 6


def texel_index(iuv: torch.Tensor, part_res: int = PART_RES):
    """(..., H, W, 3) IUV (channel 0 the part 0..24, 0 background; U, V in
    [0, 1], or [0, 255] where above 1.5) → ``(valid (..., H, W) bool, flat
    texel index (..., H, W) int64)`` into the (24·R·R) atlas: row from U,
    column from V, each ``round(·(R − 1))`` half to even; 0 where not
    valid."""
    u = iuv[..., 1].to(torch.float32)
    v = iuv[..., 2].to(torch.float32)
    u = torch.where(u > 1.5, u / 255.0, u)
    v = torch.where(v > 1.5, v / 255.0, v)
    part = torch.round(iuv[..., 0]).to(torch.int64)
    valid = part > 0
    part_idx = torch.clamp(part - 1, 0, NUM_PARTS - 1)
    tex_r = torch.clamp(torch.round(u * (part_res - 1)), 0,
                        part_res - 1).to(torch.int64)
    tex_c = torch.clamp(torch.round(v * (part_res - 1)), 0,
                        part_res - 1).to(torch.int64)
    flat = (part_idx * part_res + tex_r) * part_res + tex_c
    return valid, torch.where(valid, flat, 0)


def iuv_to_atlas_texture(image_rgb: torch.Tensor, iuv: torch.Tensor,
                         part_res: int = PART_RES
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter IUV-annotated images into the 24-part atlas.

    ``image_rgb`` (..., H, W, 3) in [0, 1] and ``iuv`` (..., H, W, 3) →
    ``(texture (..., 24, R, R, 3), mask (..., 24, R, R))``: each texel the
    mean of the pixels that land on it (0 where none does), the mask 1
    where one does."""
    lead = iuv.shape[:-3]
    n = int(np.prod(lead)) if lead else 1
    n_texels = NUM_PARTS * part_res * part_res
    valid, idx = texel_index(iuv, part_res)
    weights = valid.to(torch.float32).reshape(n, -1)
    idx = (idx.reshape(n, -1)
           + torch.arange(n, device=idx.device)[:, None] * n_texels
           ).reshape(-1)
    rgb = image_rgb.to(torch.float32).reshape(n, -1, 3) * weights[..., None]
    dev = image_rgb.device
    rgb_sum = torch.zeros((n * n_texels, 3), device=dev).index_add_(
        0, idx, rgb.reshape(-1, 3))
    cnt = torch.zeros((n * n_texels,), device=dev).index_add_(
        0, idx, weights.reshape(-1))
    texture = rgb_sum / torch.clamp(cnt[:, None], min=1.0)
    mask = (cnt > 0).to(torch.float32)
    return (texture.reshape(lead + (NUM_PARTS, part_res, part_res, 3)),
            mask.reshape(lead + (NUM_PARTS, part_res, part_res)))


def fuse_atlas_textures(textures: torch.Tensor, masks: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask-weighted mean over frames: ``textures`` (T, 24, R, R, 3),
    ``masks`` (T, 24, R, R) → ``(texture (24, R, R, 3), mask (24, R,
    R))``."""
    w = masks[..., None]
    total = torch.sum(textures * w, dim=0)
    cnt = torch.sum(w, dim=0)
    return (total / torch.clamp(cnt, min=1.0),
            (cnt[..., 0] > 0).to(torch.float32))


def concat_atlas(parts: torch.Tensor) -> torch.Tensor:
    """(24, R, R, C) → (4R, 6R, C) tile sheet, part 6·i + j at tile (i, j)."""
    r = parts.shape[1]
    rest = tuple(parts.shape[3:])
    grid = parts.reshape((GRID_ROWS, GRID_COLS, r, r) + rest)
    return grid.transpose(1, 2).reshape(
        (GRID_ROWS * r, GRID_COLS * r) + rest)


def split_atlas(sheet: torch.Tensor, part_res: int = PART_RES
                ) -> torch.Tensor:
    """(4R, 6R, C) tile sheet → (24, R, R, C)."""
    r = part_res
    rest = tuple(sheet.shape[2:])
    grid = sheet[:GRID_ROWS * r, :GRID_COLS * r].reshape(
        (GRID_ROWS, r, GRID_COLS, r) + rest)
    return grid.transpose(1, 2).reshape((NUM_PARTS, r, r) + rest)


def _procedural_mapping(normal_res: int, part_res: int):
    """The atlas ⇄ normal mapping when no pickle is given: the 24 parts
    packed as 4 × 6 tiles of the normal map. Returns (part, y, x) int32
    arrays (normal_res, normal_res)."""
    tile_h = normal_res // GRID_ROWS
    tile_w = normal_res // GRID_COLS
    ys = np.arange(normal_res)
    xs = np.arange(normal_res)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    part = np.clip(yy // tile_h, 0, GRID_ROWS - 1) * GRID_COLS + \
        np.clip(xx // tile_w, 0, GRID_COLS - 1)
    within_y = ((yy % tile_h) * (part_res - 1)
                / max(tile_h - 1, 1)).astype(np.int32)
    within_x = ((xx % tile_w) * (part_res - 1)
                / max(tile_w - 1, 1)).astype(np.int32)
    return part.astype(np.int32), within_y, within_x


def _load_mapping(path: str):
    """A mapping pickle: this package's dense dict ({'part', 'y', 'x'}
    full-grid arrays) or the reference's relation list (K entries of 5
    ints). Returns ('dict', part, y, x) or ('list', (K, 5) int64 array)."""
    with open(path, "rb") as f:
        mapping = pickle.load(f)
    if isinstance(mapping, dict):
        return ("dict", np.asarray(mapping["part"]), np.asarray(mapping["y"]),
                np.asarray(mapping["x"]))
    rel = np.asarray(mapping, np.int64)
    if rel.ndim != 2 or rel.shape[1] != 5:
        raise ValueError(
            f"unrecognized mapping pickle layout: shape {rel.shape}")
    return ("list", rel)


def _long(a: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def atlas_to_normal(atlas: torch.Tensor, normal_res: int = 512,
                    mapping_pickle: Optional[str] = None) -> torch.Tensor:
    """24-part atlas (24, R, R, C) → normal UV map (normal_res, normal_res,
    C), values passed through unscaled. A reference relation list's
    entries are [normal_y, normal_x, part, atlas_i, atlas_j]; texels it
    does not name stay 0."""
    dev = atlas.device
    r = atlas.shape[1]
    if mapping_pickle:
        loaded = _load_mapping(mapping_pickle)
        if loaded[0] == "list":
            rel = _long(loaded[1], dev)
            normal = torch.zeros((normal_res, normal_res, atlas.shape[-1]),
                                 dtype=atlas.dtype, device=dev)
            normal[rel[:, 0], rel[:, 1]] = atlas[rel[:, 2], rel[:, 3],
                                                 rel[:, 4]]
            return normal
        _, part, wy, wx = loaded
    else:
        part, wy, wx = _procedural_mapping(normal_res, r)
    return atlas[_long(part, dev), _long(wy, dev), _long(wx, dev)]


def normal_to_atlas(normal: torch.Tensor, part_res: int = PART_RES,
                    mapping_pickle: Optional[str] = None) -> torch.Tensor:
    """Normal UV map (H, W, C) → 24-part atlas (24, R, R, C).

    A reference relation list ([atlas_i, atlas_j, part, normal_y,
    normal_x] per entry) is applied as a set; a dense dict mapping as a
    mean over the normal texels that map to each atlas texel; without a
    pickle each atlas texel gathers its tile location (so every texel is
    covered)."""
    dev = normal.device
    c = normal.shape[-1]
    if mapping_pickle:
        loaded = _load_mapping(mapping_pickle)
        if loaded[0] == "list":
            rel = _long(loaded[1], dev)
            atlas = torch.zeros((NUM_PARTS, part_res, part_res, c),
                                dtype=normal.dtype, device=dev)
            atlas[rel[:, 2], rel[:, 0], rel[:, 1]] = normal[rel[:, 3],
                                                            rel[:, 4]]
            return atlas
        part, wy, wx = (_long(a, dev) for a in loaded[1:])
        flat = ((part * part_res + wy) * part_res + wx).reshape(-1)
        n = NUM_PARTS * part_res * part_res
        total = torch.zeros((n, c), device=dev).index_add_(
            0, flat, normal.reshape(-1, c).to(torch.float32))
        cnt = torch.zeros((n,), device=dev).index_add_(
            0, flat, torch.ones(flat.shape, device=dev))
        return (total / torch.clamp(cnt[:, None], min=1.0)).reshape(
            NUM_PARTS, part_res, part_res, c)

    res = normal.shape[0]
    tile_h = res // GRID_ROWS
    tile_w = res // GRID_COLS
    pi = np.arange(NUM_PARTS)
    rows = (pi // GRID_COLS)[:, None, None]
    cols = (pi % GRID_COLS)[:, None, None]
    ii = np.arange(part_res)[None, :, None]
    jj = np.arange(part_res)[None, None, :]
    ny = rows * tile_h + np.round(
        ii * (tile_h - 1) / (part_res - 1)).astype(np.int64)
    nx = cols * tile_w + np.round(
        jj * (tile_w - 1) / (part_res - 1)).astype(np.int64)
    ny, nx = np.broadcast_arrays(ny, nx)
    return normal[_long(ny, dev), _long(nx, dev)]


def sample_uv_texture(texture: torch.Tensor, uv: torch.Tensor
                      ) -> torch.Tensor:
    """Bilinear lookup in the (H, W, C) map ``texture`` at ``uv`` (..., 2)
    in [0, 1] (u → x, v → y; corners at texel centres, clamped at the
    border) → (..., C)."""
    h, w = texture.shape[:2]
    x = uv[..., 0] * (w - 1)
    y = uv[..., 1] * (h - 1)
    x0 = torch.clamp(torch.floor(x), 0, w - 1)
    y0 = torch.clamp(torch.floor(y), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0i, x1i, y0i, y1i = (a.to(torch.int64) for a in (x0, x1, y0, y1))
    top = texture[y0i, x0i] * (1 - wx) + texture[y0i, x1i] * wx
    bot = texture[y1i, x0i] * (1 - wx) + texture[y1i, x1i] * wx
    return top * (1 - wy) + bot * wy
