"""Multi-view alternating fit with a shared pose and shape, batched.

Counterpart of ``soccerplayershapepose_tpu/fit/multi_view.py``: each
player is seen in V views; the shared body pose and betas start at the
mean over the views' single-view results (the rotation matrices are
averaged as they are, off the rotation manifold, like the reference), then
``rounds`` alternating rounds run

* phase A (``iters_per_phase`` iterations): each view's [global_orient,
  cam_wp] trainable, the shared pose and betas frozen;
* phase B: the shared [pose minus hands and feet, betas] trainable, the
  cameras frozen.

Each phase step evaluates all views of all players as one batch of B·V rows
and takes one Adam step on the joint objective; best-iterate selection
judges the per-player metrics averaged over the views (``group_size=V``).
The result carries the shared pose and betas, each view's orient, camera
and translation, and the per-player silhouette IoU and joint error of the
final parameters, averaged over the views.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.fit.engine import (
    FitConfig, evaluate_fit, run_fit_loop)
from soccerplayershapepose_torch.fit.single_view import (
    _TRAIN, splice_body_pose)
from soccerplayershapepose_torch.ops.camera import (
    weak_perspective_to_translation)
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, as_f32, default_device)


class MultiViewInit(NamedTuple):
    """Per-view single-view results for each player."""
    body_pose: torch.Tensor      # (B, V, 23, 3, 3)
    global_orient: torch.Tensor  # (B, V, 1, 3, 3)
    betas: torch.Tensor          # (B, V, 10)
    cam_wp: torch.Tensor         # (B, V, 3)


class MultiViewResult(NamedTuple):
    body_pose: torch.Tensor      # (B, 23, 3, 3) shared
    betas: torch.Tensor          # (B, 10) shared
    global_orient: torch.Tensor  # (B, V, 1, 3, 3)
    cam_wp: torch.Tensor         # (B, V, 3)
    translation: torch.Tensor    # (B, V, 3)
    silh_iou: torch.Tensor       # (B,) mean over views, final parameters
    joint_err: torch.Tensor      # (B,)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _assemble_mv_a(t, f):
    """Phase A: each view's [orient, cam] trainable; shared pose and betas
    frozen."""
    b, v = t["orient"].shape[:2]
    pose = splice_body_pose(f["pose_sub"], f["pose_init"])   # (B, 23, 3, 3)
    return (pose.repeat_interleave(v, dim=0),
            t["orient"].reshape(b * v, 1, 3, 3),
            f["betas"].repeat_interleave(v, dim=0),
            t["cam"].reshape(b * v, 3))


def _assemble_mv_b(t, f):
    """Phase B: the shared [pose_sub, betas] trainable; cameras frozen."""
    b, v = f["orient"].shape[:2]
    pose = splice_body_pose(t["pose_sub"], f["pose_init"])
    return (pose.repeat_interleave(v, dim=0),
            f["orient"].reshape(b * v, 1, 3, 3),
            t["betas"].repeat_interleave(v, dim=0),
            f["cam"].reshape(b * v, 3))


def multi_view_fit(assets: SMPLAssets, init: MultiViewInit, silhouettes,
                   joints2d, fit_cfg: Optional[FitConfig] = None,
                   rounds: int = cfg.MULTI_VIEW_ROUNDS,
                   iters_per_phase: int = cfg.MULTI_VIEW_ITERS,
                   mask=None, device: DeviceLike = None,
                   mesh=None) -> MultiViewResult:
    """Fit V views of each player with a shared pose and shape.

    Args:
      init: the per-view single-view (or regressor) results.
      silhouettes: (B, V, proxy_wh, proxy_wh); joints2d (B, V, 17, 2|3) px.
      fit_cfg: the loop's settings; its ``iters`` is replaced by
        ``iters_per_phase``.
      mask: (B,) validity of padded players.
      device: where to run; ``None`` means CUDA, and raises where there is
        none. Inputs are moved there.
      mesh: a ``parallel.mesh.Mesh``: each phase's loop shards the players
        (and so their B·V rows) over the data axis; B must be a multiple
        of it.
    """
    dev = default_device(device)
    fit_cfg = fit_cfg or FitConfig(iters=iters_per_phase)
    phase_cfg = dataclasses.replace(fit_cfg, iters=iters_per_phase)
    assets = assets.to(dev)
    init = MultiViewInit(*(as_f32(x, dev) for x in init))
    silhouettes, joints2d = as_f32(silhouettes, dev), as_f32(joints2d, dev)
    b, v = init.cam_wp.shape[:2]
    mask = (torch.ones((b,), device=dev) if mask is None
            else as_f32(mask, dev))
    view_mask = mask.repeat_interleave(v)

    sil_flat, j2d_flat = _flat(silhouettes), _flat(joints2d)
    # The shared init: the plain mean over the views.
    shared_pose = init.body_pose.mean(dim=1)                  # (B, 23, 3, 3)
    shared_betas = init.betas.mean(dim=1)                     # (B, 10)
    orient, cam_wp = init.global_orient, init.cam_wp
    pose_sub = shared_pose[:, _TRAIN]
    for _ in range(rounds):
        a_params, _ = run_fit_loop(
            assets, {"orient": orient, "cam": cam_wp},
            {"pose_sub": pose_sub, "betas": shared_betas,
             "pose_init": shared_pose},
            _assemble_mv_a, sil_flat, j2d_flat, phase_cfg,
            mask=view_mask, group_size=v, mesh=mesh)
        orient, cam_wp = a_params["orient"], a_params["cam"]
        b_params, _ = run_fit_loop(
            assets, {"pose_sub": pose_sub, "betas": shared_betas},
            {"orient": orient, "cam": cam_wp, "pose_init": shared_pose},
            _assemble_mv_b, sil_flat, j2d_flat, phase_cfg,
            mask=view_mask, group_size=v, mesh=mesh)
        pose_sub, shared_betas = b_params["pose_sub"], b_params["betas"]

    body_pose = splice_body_pose(pose_sub, shared_pose)
    with torch.no_grad():
        ev = evaluate_fit(assets, body_pose.repeat_interleave(v, dim=0),
                          _flat(orient), shared_betas.repeat_interleave(
                              v, dim=0), _flat(cam_wp), sil_flat, j2d_flat,
                          fit_cfg)
    translation = weak_perspective_to_translation(
        cam_wp, fit_cfg.focal_length, fit_cfg.proxy_wh)
    return MultiViewResult(
        body_pose=body_pose, betas=shared_betas, global_orient=orient,
        cam_wp=cam_wp, translation=translation,
        silh_iou=ev["iou"].reshape(b, v).mean(dim=1),
        joint_err=ev["joint_err"].reshape(b, v).mean(dim=1))
