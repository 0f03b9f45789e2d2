"""Temporal track fit: one shared shape across a broadcast clip.

Counterpart of ``soccerplayershapepose_tpu/fit/track.py``: a tracked
player appears in T consecutive frames; its betas are one physical
quantity while pose, orient and camera vary per frame. One loop optimises
each frame's [pose minus hands and feet, orient, cam] and one betas per
player, batched over players, with a per-frame validity mask for tracks of
different lengths: padded frames add no loss and carry no weight in the
per-player metrics (``group_size=T``, ``metric_weights`` the mask).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.fit.engine import FitConfig, run_fit_loop
from soccerplayershapepose_torch.fit.single_view import (
    _TRAIN, splice_body_pose)
from soccerplayershapepose_torch.ops.camera import (
    weak_perspective_to_translation)
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, as_f32, default_device)


class TrackInit(NamedTuple):
    body_pose: torch.Tensor      # (B, T, 23, 3, 3) per-frame init
    global_orient: torch.Tensor  # (B, T, 1, 3, 3)
    betas: torch.Tensor          # (B, T, 10), averaged for the shared init
    cam_wp: torch.Tensor         # (B, T, 3)


class TrackResult(NamedTuple):
    body_pose: torch.Tensor      # (B, T, 23, 3, 3)
    global_orient: torch.Tensor  # (B, T, 1, 3, 3)
    betas: torch.Tensor          # (B, 10) shared
    cam_wp: torch.Tensor         # (B, T, 3)
    translation: torch.Tensor    # (B, T, 3)
    silh_iou: torch.Tensor       # (B,) masked mean over frames, best iterate
    joint_err: torch.Tensor      # (B,)


def _assemble_track(tr, f):
    """Each frame's [pose, orient, cam] and one shared betas per player."""
    b, t = tr["cam"].shape[:2]
    pose = splice_body_pose(tr["pose_sub"].reshape(b * t, 19, 3, 3),
                            f["pose_init_flat"])
    return (pose, tr["orient"].reshape(b * t, 1, 3, 3),
            tr["betas"].repeat_interleave(t, dim=0),
            tr["cam"].reshape(b * t, 3))


def track_fit(assets: SMPLAssets, init: TrackInit, silhouettes, joints2d,
              fit_cfg: Optional[FitConfig] = None, frame_mask=None,
              device: DeviceLike = None, mesh=None) -> TrackResult:
    """Fit a clip per player with one shared shape.

    Args:
      init: the per-frame (regressor) estimates.
      silhouettes: (B, T, proxy_wh, proxy_wh); joints2d (B, T, 17, 2|3) px.
      frame_mask: (B, T) 1.0 for real frames, 0.0 for padding.
      device: where to run; ``None`` means CUDA, and raises where there is
        none. Inputs are moved there.
      mesh: a ``parallel.mesh.Mesh``: each rank fits its slice of the
        players (all of their frames) over the data axis.
    """
    dev = default_device(device)
    fit_cfg = fit_cfg or FitConfig(iters=cfg.SINGLE_VIEW_ITERS)
    assets = assets.to(dev)
    init = TrackInit(*(as_f32(x, dev) for x in init))
    silhouettes, joints2d = as_f32(silhouettes, dev), as_f32(joints2d, dev)
    b, t = init.cam_wp.shape[:2]
    frame_mask = (torch.ones((b, t), device=dev) if frame_mask is None
                  else as_f32(frame_mask, dev))
    flat_mask = frame_mask.reshape(b * t)

    trainable = {
        "pose_sub": init.body_pose[:, :, _TRAIN],             # (B, T, 19, ..)
        "orient": init.global_orient,
        "cam": init.cam_wp,
        "betas": (init.betas * frame_mask[..., None]).sum(dim=1)
        / torch.clamp(frame_mask.sum(dim=1, keepdim=True), min=1.0),
    }
    pose_init_flat = init.body_pose.reshape(b * t, 23, 3, 3)
    tr, best = run_fit_loop(
        assets, trainable, {"pose_init_flat": pose_init_flat},
        _assemble_track,
        silhouettes.reshape((b * t,) + tuple(silhouettes.shape[2:])),
        joints2d.reshape((b * t,) + tuple(joints2d.shape[2:])), fit_cfg,
        mask=flat_mask, group_size=t, metric_weights=flat_mask, mesh=mesh)

    body_pose = splice_body_pose(
        tr["pose_sub"].reshape(b * t, 19, 3, 3),
        pose_init_flat).reshape(b, t, 23, 3, 3)
    translation = weak_perspective_to_translation(
        tr["cam"], fit_cfg.focal_length, fit_cfg.proxy_wh)
    return TrackResult(body_pose=body_pose, global_orient=tr["orient"],
                       betas=tr["betas"], cam_wp=tr["cam"],
                       translation=translation,
                       silh_iou=best["iou"], joint_err=best["joint_err"])
