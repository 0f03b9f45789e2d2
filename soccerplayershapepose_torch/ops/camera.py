"""Weak-perspective and perspective cameras.

Counterpart of ``soccerplayershapepose_tpu/ops/camera.py``: the orthographic
projection applies the translation before the scale, weak-perspective →
translation uses ``t_z = 2f / (res·s + 1e-9)`` (and back, ``s = 2f /
(res·t_z + 1e-9)``), and keypoints map from [-1, 1] to [0, wh] via
``(k + 1)·wh/2`` and back via ``2k/wh − 1``.
"""

from __future__ import annotations

from typing import Optional

import torch


def orthographic_project(points3d: torch.Tensor,
                         cam_wp: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) points, (..., 3) [s, tx, ty] → (..., N, 2)
    ``(s·(x+tx), s·(y+ty))``."""
    s = cam_wp[..., 0:1]
    t = cam_wp[..., 1:3]
    return s[..., None] * (points3d[..., :2] + t[..., None, :])


def weak_perspective_to_translation(cam_wp: torch.Tensor, focal_length: float,
                                    resolution: float) -> torch.Tensor:
    """[s, tx, ty] → perspective camera translation [tx, ty, 2f/(res·s+1e-9)]."""
    tz = 2.0 * focal_length / (resolution * cam_wp[..., 0] + 1e-9)
    return torch.stack([cam_wp[..., 1], cam_wp[..., 2], tz], dim=-1)


def translation_to_weak_perspective(translation: torch.Tensor,
                                    focal_length: float,
                                    resolution: float) -> torch.Tensor:
    """Perspective camera translation → weak-perspective [s, tx, ty]."""
    s = 2.0 * focal_length / (resolution * translation[..., 2] + 1e-9)
    return torch.stack([s, translation[..., 0], translation[..., 1]], dim=-1)


def get_intrinsics_matrix(img_width: int, img_height: int, focal_length: float,
                          device=None) -> torch.Tensor:
    """3×3 pinhole intrinsics with the principal point at the image centre."""
    return torch.tensor([[focal_length, 0.0, img_width / 2.0],
                         [0.0, focal_length, img_height / 2.0],
                         [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)


def perspective_project(points: torch.Tensor,
                        rotation: Optional[torch.Tensor],
                        translation: torch.Tensor,
                        cam_k: Optional[torch.Tensor] = None,
                        focal_length: Optional[float] = None,
                        img_wh: Optional[int] = None) -> torch.Tensor:
    """(B, N, 3) points → (B, N, 2) pixel coordinates.

    ``rotation`` (B, 3, 3) or None for identity; ``translation`` (B, 3);
    ``cam_k`` (B, 3, 3) or (3, 3), else built from ``focal_length`` and
    ``img_wh``.
    """
    if cam_k is None:
        cam_k = get_intrinsics_matrix(img_wh, img_wh, focal_length,
                                      device=points.device)
    if rotation is not None:
        points = torch.einsum("bij,bkj->bki", rotation, points)
    points = points + translation[:, None, :]
    projected = points / points[..., 2:3]
    if cam_k.ndim == 2:
        projected = torch.einsum("ij,bkj->bki", cam_k, projected)
    else:
        projected = torch.einsum("bij,bkj->bki", cam_k, projected)
    return projected[..., :2]


def undo_keypoint_normalisation(keypoints: torch.Tensor,
                                img_wh: int) -> torch.Tensor:
    """[-1, 1] normalised keypoints → pixel space [0, img_wh]."""
    return (keypoints + 1.0) * (img_wh / 2.0)


def normalise_keypoints(keypoints: torch.Tensor, img_wh: int) -> torch.Tensor:
    """Pixel keypoints → [-1, 1]: ``2k/wh − 1``."""
    return (2.0 * keypoints) / img_wh - 1.0


def check_joints2d_visibility(joints2d: torch.Tensor,
                              img_wh: int) -> torch.Tensor:
    """(..., N, 2) joints → (..., N) bool: inside [0, img_wh] on both
    axes, the bounds included."""
    inside_x = (joints2d[..., 0] >= 0) & (joints2d[..., 0] <= img_wh)
    inside_y = (joints2d[..., 1] >= 0) & (joints2d[..., 1] <= img_wh)
    return inside_x & inside_y
