"""Soccer-field segmentation by hue histogram and morphology.

Counterpart of ``soccerplayershapepose_tpu/pipeline/field.py``, kept as a
copy so the port never imports the JAX package: find the dominant grass hue
from a hue histogram's peak among the greens, threshold around it (±5 for
the seed mask, ±15 for the fill), open, dilate, keep the largest 8-connected
component, close, then fill its convex hull, giving the binary field mask
that gates player detection. Host numpy and ``scipy.ndimage``, no OpenCV.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def rgb_to_hue(image_rgb: np.ndarray) -> np.ndarray:
    """Hue channel in OpenCV convention (0..179), uint8 input (H, W, 3)."""
    img = image_rgb.astype(np.float64) / 255.0
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.max(-1)
    minc = img.min(-1)
    delta = maxc - minc
    hue = np.zeros_like(maxc)
    m = delta > 1e-12
    rm = m & (maxc == r)
    gm = m & (maxc == g) & ~rm
    bm = m & (maxc == b) & ~rm & ~gm
    hue[rm] = ((g - b)[rm] / delta[rm]) % 6.0
    hue[gm] = (b - r)[gm] / delta[gm] + 2.0
    hue[bm] = (r - g)[bm] / delta[bm] + 4.0
    return (hue * 30.0).astype(np.int32) % 180      # 60°/6 → 30 per unit


def largest_connected_component(mask: np.ndarray) -> np.ndarray:
    """Binary mask of the largest 8-connected foreground component
    (the role of global_utils.py largest-CC picking)."""
    labels, n = ndimage.label(mask, structure=np.ones((3, 3)))
    if n == 0:
        return np.zeros_like(mask)
    sizes = ndimage.sum_labels(np.ones_like(labels), labels, range(1, n + 1))
    return (labels == (1 + int(np.argmax(sizes)))).astype(mask.dtype)


def convex_hull_fill(mask: np.ndarray) -> np.ndarray:
    """Fill the convex hull of the foreground (per-row span fill applied on
    the hull polygon; adequate for the field's near-convex shape)."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return mask
    pts = np.stack([xs, ys], axis=1).astype(np.float64)

    # Andrew's monotone chain convex hull.
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross(a, b):      # z of the 2-D cross product, as np.cross
        return a[0] * b[1] - a[1] * b[0]

    def half(points):
        out = []
        for p in points:
            while len(out) >= 2 and cross(out[-1] - out[-2],
                                          p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out

    hull = np.asarray(half(pts)[:-1] + half(pts[::-1])[:-1])
    h, w = mask.shape

    # Rasterize hull polygon by horizontal scanline fill.
    out = np.zeros_like(mask)
    y_grid = np.arange(h)
    x_left = np.full(h, np.inf)
    x_right = np.full(h, -np.inf)
    n = len(hull)
    for i in range(n):
        x0, y0 = hull[i]
        x1, y1 = hull[(i + 1) % n]
        if y0 == y1:
            rows = [int(round(y0))] if 0 <= y0 < h else []
            for r in rows:
                x_left[r] = min(x_left[r], x0, x1)
                x_right[r] = max(x_right[r], x0, x1)
            continue
        t = (y_grid - y0) / (y1 - y0)
        valid = (t >= 0) & (t <= 1)
        xs_line = x0 + t * (x1 - x0)
        x_left = np.where(valid, np.minimum(x_left, xs_line), x_left)
        x_right = np.where(valid, np.maximum(x_right, xs_line), x_right)

    for y in range(h):
        if x_right[y] >= x_left[y]:
            out[y, max(0, int(np.ceil(x_left[y]))):
                min(w, int(np.floor(x_right[y])) + 1)] = 1
    return out


class FieldDetector:
    """Dominant-hue field mask extractor (see module docstring)."""

    def __init__(self, tight_band: int = 5, loose_band: int = 15,
                 open_size: int = 5, dilate_size: int = 9,
                 close_size: int = 15):
        self.tight_band = tight_band
        self.loose_band = loose_band
        self.open_size = open_size
        self.dilate_size = dilate_size
        self.close_size = close_size

    def detect(self, image_rgb: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8 RGB frame → (H, W) uint8 field mask."""
        hue = rgb_to_hue(image_rgb)
        hist = np.bincount(hue.reshape(-1), minlength=180)
        # grass hue: restrict the peak search to greens (35..90 in cv2 units)
        green = np.zeros(180, bool)
        green[35:91] = True
        peak = int(np.argmax(np.where(green, hist, 0)))

        tight = (np.abs(hue - peak) <= self.tight_band)
        loose = (np.abs(hue - peak) <= self.loose_band)

        k_open = np.ones((self.open_size, self.open_size))
        k_dil = np.ones((self.dilate_size, self.dilate_size))
        k_close = np.ones((self.close_size, self.close_size))

        mask = ndimage.binary_opening(tight, structure=k_open)
        mask = ndimage.binary_dilation(mask, structure=k_dil)
        mask = mask & loose
        mask = largest_connected_component(mask.astype(np.uint8))
        mask = ndimage.binary_closing(mask, structure=k_close)
        return convex_hull_fill(mask.astype(np.uint8))
