"""Visualisation renders: mesh overlay and proxy vis.

Counterpart of ``soccerplayershapepose_tpu/render/vis.py``. The mesh
overlay tints the pixels that the projected mesh covers (the dense plain
soft silhouette at σ = 1e-6 over the whole image, coverage > 0.5), on the
device of the vertices; no kernel is involved, as in the JAX package.
The keypoint stamps and the proxy vis are host numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from soccerplayershapepose_torch.ops.camera import (
    orthographic_project, undo_keypoint_normalisation)
from soccerplayershapepose_torch.render.softras import soft_silhouette


def render_mesh_overlay(vertices: torch.Tensor, faces: torch.Tensor,
                        cam_wp: torch.Tensor, image: np.ndarray,
                        color=(120, 120, 230), alpha: float = 0.7
                        ) -> np.ndarray:
    """Composite the projected mesh over the source image.

    Args:
      vertices: (V, 3) SMPL vertices (single mesh).
      faces: (F, 3), on the vertices' device.
      cam_wp: (3,) weak-perspective camera.
      image: (H, W, 3) uint8 background.
    """
    wh = image.shape[0]
    with torch.no_grad():
        v2d = orthographic_project(vertices[None], cam_wp[None])
        v2d = undo_keypoint_normalisation(v2d, wh)
        cover = soft_silhouette(v2d, faces, wh, sigma=1e-6)[0].cpu().numpy()

    out = image.astype(np.float32)
    tint = np.asarray(color, np.float32)
    mask = (cover > 0.5)[..., None]
    out = np.where(mask, (1 - alpha) * out + alpha * tint, out)
    return out.astype(np.uint8)


def draw_keypoints(image: np.ndarray, joints2d: np.ndarray,
                   radius: int = 3, color=(0, 255, 0)) -> np.ndarray:
    """Stamp keypoint discs onto an image (proxy vis)."""
    out = image.copy()
    h, w = out.shape[:2]
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disc = (yy ** 2 + xx ** 2) <= radius ** 2
    for x, y in np.asarray(joints2d)[:, :2]:
        cx, cy = int(round(float(x))), int(round(float(y)))
        if 0 <= cx < w and 0 <= cy < h:
            y0, y1 = max(0, cy - radius), min(h, cy + radius + 1)
            x0, x1 = max(0, cx - radius), min(w, cx + radius + 1)
            d = disc[y0 - (cy - radius):disc.shape[0] - ((cy + radius + 1) - y1),
                     x0 - (cx - radius):disc.shape[1] - ((cx + radius + 1) - x1)]
            out[y0:y1, x0:x1][d] = color
    return out


def proxy_vis(silhouette: np.ndarray, joints2d: np.ndarray) -> np.ndarray:
    """Silhouette + keypoints overlay image."""
    img = (np.asarray(silhouette) * 128).astype(np.uint8)
    img = np.stack([img] * 3, axis=-1)
    return draw_keypoints(img, joints2d)
