"""Rotation representations: 6D ⇄ rotmat, axis-angle ⇄ rotmat, and rigid
transforms of point sets.

Counterpart of ``soccerplayershapepose_tpu/ops/rotations.py``; same layouts
and epsilons.
"""

from __future__ import annotations

import torch


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``v / max(||v||, eps)`` along the last axis."""
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(norm, min=eps)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """(..., 6) Zhou 6D rotations → (..., 3, 3) with columns (b1, b2, b1×b2).

    The flat layout is [a1x, a2x, a1y, a2y, a1z, a2z] (a (3, 2) matrix in
    row-major order).
    """
    m = x.reshape(x.shape[:-1] + (3, 2))
    a1, a2 = m[..., 0], m[..., 1]
    b1 = _normalize(a1)
    b2 = _normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def rotmat_to_rot6d(r: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) → (..., 6): the first two columns in the flat layout of
    :func:`rot6d_to_rotmat`, which inverts it on SO(3)."""
    return r[..., :, :2].reshape(r.shape[:-2] + (6,))


def batch_rodrigues(aa: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 3) axis-angle → (..., 3, 3): ``I + sin θ K + (1 − cos θ) K²``
    with ``θ = sqrt(||aa||² + eps²)``."""
    angle = torch.sqrt(torch.sum(aa * aa, dim=-1, keepdim=True) + eps * eps)
    axis = aa / angle
    sin = torch.sin(angle)[..., None]
    cos = torch.cos(angle)[..., None]
    kx, ky, kz = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(kx)
    k = torch.stack([
        torch.stack([zeros, -kz, ky], dim=-1),
        torch.stack([kz, zeros, -kx], dim=-1),
        torch.stack([-ky, kx, zeros], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + sin * k + (1.0 - cos) * torch.matmul(k, k)


def rotmat_to_axis_angle(r: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 3, 3) → (..., 3), the log map of SO(3): the skew part scaled by
    θ / (2 sin θ) with θ = arccos((tr − 1) / 2) (by 1/2 where |sin θ| ≤
    ``eps``). Stable away from θ = π; exports fitted rotations as SMPL
    axis-angle (the HMR prediction format)."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    angle = torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
    skew = torch.stack([r[..., 2, 1] - r[..., 1, 2],
                        r[..., 0, 2] - r[..., 2, 0],
                        r[..., 1, 0] - r[..., 0, 1]], dim=-1)
    sin = torch.abs(torch.sin(angle))
    scale = torch.where(sin > eps, angle / (2.0 * torch.clamp(sin, min=eps)),
                        0.5)
    return skew * scale[..., None]


def rotate_translate_points(points: torch.Tensor, rotmat: torch.Tensor,
                            translation: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) points → ``points @ Rᵀ + t`` with ``rotmat`` (3, 3) or
    (B, 3, 3) and ``translation`` (3,) or (B, 3)."""
    if rotmat.ndim == 2:
        out = torch.einsum("ij,bkj->bki", rotmat, points)
    else:
        out = torch.einsum("bij,bkj->bki", rotmat, points)
    if translation.ndim == 1:
        return out + translation[None, None, :]
    return out + translation[:, None, :]
