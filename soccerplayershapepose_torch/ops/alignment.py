"""Batched alignment for the -PA and -SC metrics.

Counterpart of ``soccerplayershapepose_tpu/ops/alignment.py``:

* ``procrustes_align``: similarity Procrustes (Umeyama) through an fp32
  SVD of the 3×3 cross-covariance, with the determinant's sign fix so the
  result is a rotation, not a reflection;
* ``scale_and_translation_align``: normalise to zero mean and unit RMS,
  then take on the target's mean and RMS.
"""

from __future__ import annotations

import torch


def procrustes_align(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) source and target → (B, N, 3) ``scale·R·s1 + t`` that is
    nearest to s2 in L2."""
    x1 = s1.transpose(-1, -2)
    x2 = s2.transpose(-1, -2)
    mu1 = x1.mean(dim=-1, keepdim=True)
    mu2 = x2.mean(dim=-1, keepdim=True)
    c1 = x1 - mu1
    c2 = x2 - mu2
    var1 = torch.sum(c1 * c1, dim=(-1, -2))
    k = c1 @ c2.transpose(-1, -2)                                # (B, 3, 3)

    u, _, vh = torch.linalg.svd(k)
    v = vh.transpose(-1, -2)
    det = torch.linalg.det(u @ v.transpose(-1, -2))
    z = torch.eye(3, dtype=s1.dtype, device=s1.device).expand(
        k.shape).clone()
    z[..., 2, 2] = torch.sign(det)
    r = v @ (z @ u.transpose(-1, -2))

    scale = torch.diagonal(r @ k, dim1=-2, dim2=-1).sum(-1) / var1
    t = mu2 - scale[..., None, None] * (r @ mu1)
    aligned = scale[..., None, None] * (r @ x1) + t
    return aligned.transpose(-1, -2)


def scale_and_translation_align(p: torch.Tensor,
                                t: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) points p and reference t → p with t's mean and RMS."""
    n = p.shape[-2]
    p_c = p - p.mean(dim=-2, keepdim=True)
    p_scale = torch.sqrt(torch.sum(p_c * p_c, dim=(-1, -2), keepdim=True) / n)
    t_mean = t.mean(dim=-2, keepdim=True)
    t_c = t - t_mean
    t_scale = torch.sqrt(torch.sum(t_c * t_c, dim=(-1, -2), keepdim=True) / n)
    return p_c / p_scale * t_scale + t_mean
