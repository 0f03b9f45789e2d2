"""Batched SMPL forward: blendshapes, kinematic chain, linear blend skinning.

Counterpart of ``soccerplayershapepose_tpu/smpl/model.py``. Output joints are
the 90-joint superset: 24 posed kinematic joints, 21 vertex-selected joints,
then 9 extra + 19 cocoplus + 17 H36M regressed joints. Runs on the device of
its inputs; every contraction is fp32 (TF32 is pinned off in
``utils/precision.py``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.ops.rotations import batch_rodrigues
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.utils import precision  # noqa: F401  (pins TF32 off)
from soccerplayershapepose_torch.utils import profiling


class SMPLOutput(NamedTuple):
    vertices: torch.Tensor      # (B, 6890, 3)
    joints: torch.Tensor        # (B, 90, 3)
    kin_joints: torch.Tensor    # (B, 24, 3)
    v_shaped: torch.Tensor      # (B, 6890, 3)


@functools.lru_cache(maxsize=None)
def _chain_constants(parents: tuple, dtype: torch.dtype,
                     device: torch.device):
    """The parent index (long) and the homogeneous row [0, 0, 0, 1] of the
    kinematic chain, built once per device: a copy from the host in every
    call would make the host wait, and a CUDA graph cannot hold one.
    Read-only."""
    parent_idx = torch.as_tensor(parents[1:], dtype=torch.long,
                                 device=device)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)
    return parent_idx, bottom


def _kinematic_chain(rotmats: torch.Tensor, joints: torch.Tensor, parents):
    """Forward kinematics over the static tree.

    Returns posed joints (B, 24, 3) and skinning transforms (B, 24, 4, 4)
    with the rest-pose joint locations already subtracted.
    """
    b = rotmats.shape[0]
    parent_idx, bottom = _chain_constants(tuple(parents), rotmats.dtype,
                                          rotmats.device)
    rel = joints - torch.cat([torch.zeros_like(joints[:, :1]),
                              joints[:, parent_idx]], dim=1)
    bottom = bottom.expand(b, 1, 4)

    def make44(r, t):
        return torch.cat([torch.cat([r, t[..., None]], dim=-1), bottom], dim=-2)

    world = [make44(rotmats[:, 0], rel[:, 0])]
    for j in range(1, cfg.NUM_JOINTS):
        world.append(torch.matmul(world[parents[j]],
                                  make44(rotmats[:, j], rel[:, j])))
    world = torch.stack(world, dim=1)                          # (B,24,4,4)

    posed_joints = world[..., :3, 3]
    correction = torch.einsum("bjxy,bjy->bjx", world[..., :3, :3], joints)
    rel_transforms = torch.cat(
        [world[..., :3, :3],
         (world[..., :3, 3] - correction)[..., None]], dim=-1)  # (B,24,3,4)
    return posed_joints, rel_transforms


def smpl_forward(assets: SMPLAssets,
                 betas: torch.Tensor,
                 body_pose: torch.Tensor,
                 global_orient: torch.Tensor,
                 transl: Optional[torch.Tensor] = None,
                 pose2rot: bool = False) -> SMPLOutput:
    """Batched SMPL forward pass.

    Args:
      betas: (B, 10).
      body_pose: (B, 23, 3, 3) rotmats, or axis-angle (B, 23, 3)/(B, 69)
        when ``pose2rot``.
      global_orient: (B, 1, 3, 3) rotmats, or (B, 3)/(B, 1, 3) axis-angle.
      transl: optional (B, 3) added to vertices and joints.

    The call is the span ``smpl.forward`` (``utils/profiling.py``).
    """
    with profiling.span("smpl.forward"):
        return _smpl_forward(assets, betas, body_pose, global_orient, transl,
                             pose2rot)


def _smpl_forward(assets: SMPLAssets, betas, body_pose, global_orient,
                  transl, pose2rot: bool) -> SMPLOutput:
    b = betas.shape[0]
    if pose2rot:
        body_rot = batch_rodrigues(body_pose.reshape(b, cfg.NUM_BODY_JOINTS, 3))
        orient_rot = batch_rodrigues(global_orient.reshape(b, 1, 3))
    else:
        body_rot, orient_rot = body_pose, global_orient
    rotmats = torch.cat([orient_rot, body_rot], dim=1)          # (B,24,3,3)

    v_shaped = assets.v_template[None] + torch.einsum(
        "bl,vcl->bvc", betas, assets.shapedirs)
    joints = torch.einsum("jv,bvc->bjc", assets.j_regressor, v_shaped)

    eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    pose_feature = (body_rot - eye).reshape(b, cfg.NUM_POSE_BLENDSHAPES)
    pose_offsets = torch.matmul(pose_feature, assets.posedirs).reshape(
        b, -1, 3)
    v_posed = v_shaped + pose_offsets

    posed_joints, rel_transforms = _kinematic_chain(rotmats, joints,
                                                    assets.parents)
    t_blend = torch.einsum("vj,bjxy->bvxy", assets.lbs_weights,
                           rel_transforms)                     # (B,V,3,4)
    verts = torch.einsum("bvxy,bvy->bvx", t_blend[..., :3], v_posed) \
        + t_blend[..., 3]

    vertex_joints = verts[:, assets.extra_joint_vertex_ids]
    extra = torch.einsum("jv,bvc->bjc", assets.j_regressor_extra, verts)
    cocoplus = torch.einsum("jv,bvc->bjc", assets.j_regressor_cocoplus, verts)
    h36m = torch.einsum("jv,bvc->bjc", assets.j_regressor_h36m, verts)
    all_joints = torch.cat([posed_joints, vertex_joints, extra, cocoplus,
                            h36m], dim=1)

    if transl is not None:
        verts = verts + transl[:, None, :]
        all_joints = all_joints + transl[:, None, :]
        posed_joints = posed_joints + transl[:, None, :]
    return SMPLOutput(vertices=verts, joints=all_joints,
                      kin_joints=posed_joints, v_shaped=v_shaped)


def smpl_shape_only(assets: SMPLAssets, betas: torch.Tensor) -> torch.Tensor:
    """T-pose vertices from betas alone."""
    return assets.v_template[None] + torch.einsum("bl,vcl->bvc", betas,
                                                  assets.shapedirs)
