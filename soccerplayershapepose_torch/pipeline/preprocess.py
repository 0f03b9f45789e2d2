"""Host image preprocessing: square crops, padding, bbox conversions.

Counterpart of ``soccerplayershapepose_tpu/pipeline/preprocess.py``, kept as
a copy so the port never imports the JAX package. Every function is host
numpy, as the JAX module's are:

* bbox corner ⇄ centre/size conversions and the centre-most detection,
* pad-to-square,
* the square crop around a bbox with a constant border, padded with the
  field green (53, 88, 83) BGR where the crop leaves the frame, resized by
  nearest index,
* the batched crop-with-jitter augmentation of silhouettes and joints, and
  the directional motion blur of broadcast crops.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from soccerplayershapepose_torch import config as cfg


def corners_to_centre_size(boxes: np.ndarray) -> np.ndarray:
    """(..., 4) [x1,y1,x2,y2] → [cx, cy, w, h]."""
    boxes = np.asarray(boxes, np.float64)
    cx = (boxes[..., 0] + boxes[..., 2]) / 2.0
    cy = (boxes[..., 1] + boxes[..., 3]) / 2.0
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return np.stack([cx, cy, w, h], axis=-1)


def centre_size_to_corners(boxes: np.ndarray) -> np.ndarray:
    """(..., 4) [cx, cy, w, h] → [x1, y1, x2, y2]."""
    boxes = np.asarray(boxes, np.float64)
    half_w = boxes[..., 2] / 2.0
    half_h = boxes[..., 3] / 2.0
    return np.stack([boxes[..., 0] - half_w, boxes[..., 1] - half_h,
                     boxes[..., 0] + half_w, boxes[..., 1] + half_h], axis=-1)


def get_centre_object(boxes: np.ndarray, frame_hw: Tuple[int, int]) -> int:
    """Index of the detection whose centre is nearest the frame centre."""
    boxes = np.asarray(boxes)
    centre = np.array([frame_hw[1] / 2.0, frame_hw[0] / 2.0])
    cs = corners_to_centre_size(boxes)[..., :2]
    return int(np.argmin(np.linalg.norm(cs - centre, axis=-1)))


def pad_to_square(image: np.ndarray) -> np.ndarray:
    """Pad the shorter side with zeros (bottom or right) so H == W."""
    h, w = image.shape[:2]
    side = max(h, w)
    out = np.zeros((side, side) + image.shape[2:], dtype=image.dtype)
    out[:h, :w] = image
    return out


def square_crop_padded(image: np.ndarray, box: np.ndarray,
                       border: int = cfg.PLAYER_CROP_BORDER,
                       out_size: int = cfg.PLAYER_CROP_SIZE[0],
                       pad_color=cfg.CROP_PAD_COLOR_BGR) -> np.ndarray:
    """Square crop around a bbox, green-padded at frame edges, resized.

    The crop is the bbox (corners rounded) grown by ``border`` px, squared
    on its longer side about its integer centre; what lies off the frame is
    ``pad_color`` (zeros for a 2-D image). Resized to ``out_size``² by
    nearest index (``floor(i · side / out_size)``).
    """
    h, w = image.shape[:2]
    x1, y1, x2, y2 = [int(round(float(v))) for v in box]
    x1, y1 = x1 - border, y1 - border
    x2, y2 = x2 + border, y2 + border
    side = max(x2 - x1, y2 - y1)
    cx, cy = (x1 + x2) // 2, (y1 + y2) // 2
    x1, x2 = cx - side // 2, cx - side // 2 + side
    y1, y2 = cy - side // 2, cy - side // 2 + side

    out = np.empty((side, side) + image.shape[2:], dtype=image.dtype)
    out[...] = np.asarray(pad_color, dtype=image.dtype) if image.ndim == 3 else 0
    sx1, sy1 = max(0, x1), max(0, y1)
    sx2, sy2 = min(w, x2), min(h, y2)
    out[sy1 - y1:sy2 - y1, sx1 - x1:sx2 - x1] = image[sy1:sy2, sx1:sx2]

    if side == out_size:
        return out
    ys = (np.arange(out_size) * side / out_size).astype(np.int64)
    xs = (np.arange(out_size) * side / out_size).astype(np.int64)
    return out[ys][:, xs]


def batch_crop_seg_to_bbox(seg: np.ndarray, joints2d: np.ndarray,
                           orig_scale_factor: float = 1.2,
                           delta_scale_range=(-0.2, 0.2),
                           delta_centre_range=(-5, 5),
                           rng: np.random.RandomState | None = None):
    """Crop each (H, W) segmentation and its joints to a jittered square
    box about the mask's bbox, and resize back to (H, W) by nearest index
    (training augmentation). Draws from ``rng`` (default
    ``RandomState(0)``) in the JAX module's order: scale, then centre y,
    then centre x, per non-empty mask."""
    rng = rng or np.random.RandomState(0)
    seg = np.asarray(seg)
    joints2d = np.asarray(joints2d)
    b, h, w = seg.shape
    out_seg = np.zeros_like(seg)
    out_joints = joints2d.copy()
    for i in range(b):
        ys, xs = np.nonzero(seg[i])
        if len(ys) == 0:
            out_seg[i] = seg[i]
            continue
        cy, cx = (ys.min() + ys.max()) / 2, (xs.min() + xs.max()) / 2
        side = max(ys.max() - ys.min(), xs.max() - xs.min()) * orig_scale_factor
        side *= 1.0 + rng.uniform(*delta_scale_range)
        cy += rng.uniform(*delta_centre_range)
        cx += rng.uniform(*delta_centre_range)
        y1, y2 = int(cy - side / 2), int(cy + side / 2)
        x1, x2 = int(cx - side / 2), int(cx + side / 2)
        crop = np.zeros((max(y2 - y1, 1), max(x2 - x1, 1)), seg.dtype)
        sy1, sy2 = max(0, y1), min(h, y2)
        sx1, sx2 = max(0, x1), min(w, x2)
        crop[sy1 - y1:sy2 - y1, sx1 - x1:sx2 - x1] = seg[i, sy1:sy2, sx1:sx2]
        side_px = crop.shape[0]
        ys_idx = (np.arange(h) * side_px / h).astype(np.int64)
        xs_idx = (np.arange(w) * side_px / w).astype(np.int64)
        out_seg[i] = crop[np.minimum(ys_idx, side_px - 1)][:,
                          np.minimum(xs_idx, crop.shape[1] - 1)]
        out_joints[i, :, 0] = (joints2d[i, :, 0] - x1) * w / crop.shape[1]
        out_joints[i, :, 1] = (joints2d[i, :, 1] - y1) * h / side_px
    return out_seg, out_joints


def add_motion_blur(image: np.ndarray, kernel_size: int,
                    horizontal: bool = True) -> np.ndarray:
    """Directional mean filter of ``kernel_size`` taps, edge-padded,
    truncated to uint8 (training augmentation of broadcast crops)."""
    image = np.asarray(image, np.float64)
    k = kernel_size
    out = np.zeros_like(image)
    if horizontal:
        padded = np.pad(image, ((0, 0), (k // 2, k - 1 - k // 2)) +
                        ((0, 0),) * (image.ndim - 2), mode="edge")
        for i in range(k):
            out += padded[:, i:i + image.shape[1]]
    else:
        padded = np.pad(image, ((k // 2, k - 1 - k // 2), (0, 0)) +
                        ((0, 0),) * (image.ndim - 2), mode="edge")
        for i in range(k):
            out += padded[i:i + image.shape[0], :]
    return (out / k).astype(np.uint8)
