"""Single-view render-and-compare fit, batched over players.

Counterpart of ``soccerplayershapepose_tpu/fit/single_view.py``: Adam
(lr 0.001) over [global_orient, body_pose minus hands and feet, cam_wp,
betas] with the joints2D (+ silhouette) homoscedastic loss; the hand and
foot joints {6, 7, 21, 22} stay at their initial values; the best iterate
is kept under the all-metrics-improve rule.
"""

from __future__ import annotations

from typing import Optional

import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.fit.engine import (
    FitConfig, FitInit, FitResult, run_fit_loop)
from soccerplayershapepose_torch.ops.camera import (
    weak_perspective_to_translation)
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, as_f32, default_device)

_TRAIN = list(cfg.FITTING_TRAINABLE_BODY_JOINTS)


def splice_body_pose(pose_sub: torch.Tensor,
                     full_init: torch.Tensor) -> torch.Tensor:
    """Recombine the 19 trainable body joints with the 4 frozen ones:
    [sub[:6], init[6:8], sub[6:19], init[21:23]]."""
    return torch.cat([pose_sub[:, :6], full_init[:, 6:8],
                      pose_sub[:, 6:19], full_init[:, 21:23]], dim=1)


def _assemble_single(t, f):
    body_pose = splice_body_pose(t["pose_sub"], f["body_pose_init"])
    return body_pose, t["global_orient"], t["betas"], t["cam_wp"]


def single_view_fit(assets: SMPLAssets,
                    init: FitInit,
                    silhouette,
                    joints2d,
                    fit_cfg: Optional[FitConfig] = None,
                    mask=None,
                    device: DeviceLike = None,
                    mesh=None) -> FitResult:
    """Optimise each player-view independently (batched).

    Args:
      init: initial estimates, tensors or numpy arrays.
      silhouette: (B, proxy_wh, proxy_wh) target masks.
      joints2d: (B, 17, 2|3) target keypoints (px).
      mask: (B,) validity of padded slots.
      device: where to run; ``None`` means CUDA, and raises where there is
        none. Inputs are moved there.
      mesh: a ``parallel.mesh.Mesh``: each rank fits its slice of the
        players over the data axis (``fit/engine.py:run_fit_loop``) and
        returns all of them.
    """
    dev = default_device(device)
    fit_cfg = fit_cfg or FitConfig()
    assets = assets.to(dev)
    init = FitInit(*(as_f32(x, dev) for x in init))
    silhouette = as_f32(silhouette, dev)
    joints2d = as_f32(joints2d, dev)
    if mask is not None:
        mask = as_f32(mask, dev)

    trainable = {
        "global_orient": init.global_orient,
        "pose_sub": init.body_pose[:, _TRAIN],
        "cam_wp": init.cam_wp,
        "betas": init.betas,
    }
    frozen = {"body_pose_init": init.body_pose}
    if fit_cfg.pose_prior:
        frozen["pose_prior_ref"] = init.body_pose

    best_params, best = run_fit_loop(assets, trainable, frozen,
                                     _assemble_single, silhouette, joints2d,
                                     fit_cfg, mask, mesh=mesh)
    translation = weak_perspective_to_translation(
        best_params["cam_wp"], fit_cfg.focal_length, fit_cfg.proxy_wh)
    snapshots = None
    if best.get("snapshots") is not None:
        snap = best["snapshots"]
        snapshots = {
            "body_pose": torch.stack([splice_body_pose(s, init.body_pose)
                                      for s in snap["pose_sub"]]),
            "global_orient": snap["global_orient"],
            "betas": snap["betas"],
            "cam_wp": snap["cam_wp"],
            "translation": weak_perspective_to_translation(
                snap["cam_wp"], fit_cfg.focal_length, fit_cfg.proxy_wh),
        }
    return FitResult(
        body_pose=splice_body_pose(best_params["pose_sub"], init.body_pose),
        global_orient=best_params["global_orient"],
        betas=best_params["betas"],
        cam_wp=best_params["cam_wp"],
        translation=translation,
        silh_iou=best["iou"],
        joint_err=best["joint_err"],
        init_silh_iou=best["init_iou"],
        init_joint_err=best["init_joint_err"],
        best_iter=best["iter"],
        snapshots=snapshots,
    )
