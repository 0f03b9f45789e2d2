"""Per-sample 3-D error measures (the PVE and MPJPE families).

Counterpart of ``soccerplayershapepose_tpu/metrics/measures.py``: each
measure returns the per-sample SUM over elements (vertices or joints); the
trackers divide epoch sums by samples · elements per sample. ``*_sc``
aligns scale and translation, ``*_pa`` applies Procrustes alignment, before
the L2 norm.
"""

from __future__ import annotations

import torch

from soccerplayershapepose_torch.ops.alignment import (
    procrustes_align, scale_and_translation_align)


def _sum_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(a - b, dim=-1).sum(dim=-1)   # (B,)


def pve(pred_verts, target_verts):
    return _sum_l2(pred_verts, target_verts)


def pve_sc(pred_verts, target_verts):
    return _sum_l2(scale_and_translation_align(pred_verts, target_verts),
                   target_verts)


def pve_pa(pred_verts, target_verts):
    return _sum_l2(procrustes_align(pred_verts, target_verts), target_verts)


def mpjpe(pred_joints, target_joints):
    return _sum_l2(pred_joints, target_joints)


def mpjpe_sc(pred_joints, target_joints):
    return _sum_l2(scale_and_translation_align(pred_joints, target_joints),
                   target_joints)


def mpjpe_pa(pred_joints, target_joints):
    return _sum_l2(procrustes_align(pred_joints, target_joints),
                   target_joints)


def pose_mse(pred_rotmats, target_rotmats):
    """Per-sample SUM of squared rotation-matrix differences."""
    return ((pred_rotmats - target_rotmats) ** 2).sum(dim=(-3, -2, -1))


def shape_mse(pred_betas, target_betas):
    return ((pred_betas - target_betas) ** 2).sum(dim=-1)
