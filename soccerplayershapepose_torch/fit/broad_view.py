"""Broadcast-view transfer fit, batched over players.

Counterpart of ``soccerplayershapepose_tpu/fit/broad_view.py``: the body
pose and betas stay fixed at the multi-view result, the regressor's global
orient and camera on the broadcast crop are the init, and Adam (lr 0.01,
100 iterations) optimises only [global_orient, cam_wp] with the joints2D
(+ silhouette) loss, keeping the best iterate.
"""

from __future__ import annotations

from typing import Optional

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.fit.engine import (
    FitConfig, FitResult, run_fit_loop)
from soccerplayershapepose_torch.ops.camera import (
    weak_perspective_to_translation)
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, as_f32, default_device)


def _assemble_broad(t, f):
    return f["body_pose"], t["global_orient"], f["betas"], t["cam_wp"]


def broad_view_fit(assets: SMPLAssets, body_pose, betas, orient_init,
                   cam_init, silhouette, joints2d,
                   fit_cfg: Optional[FitConfig] = None, mask=None,
                   device: DeviceLike = None, mesh=None) -> FitResult:
    """Fit each player's global orient and camera on its broadcast view.

    Args:
      body_pose: (B, 23, 3, 3), fixed.
      betas: (B, 10), fixed.
      orient_init: (B, 1, 3, 3) and cam_init (B, 3): the regressor's init.
      silhouette: (B, proxy_wh, proxy_wh); joints2d (B, 17, 2|3) px.
      mask: (B,) validity of padded slots.
      device: where to run; ``None`` means CUDA, and raises where there is
        none. Inputs are moved there.
      mesh: a ``parallel.mesh.Mesh``: each rank fits its slice of the
        players over the data axis.
    """
    dev = default_device(device)
    fit_cfg = fit_cfg or FitConfig(iters=cfg.BROAD_VIEW_ITERS,
                                   lr=cfg.BROAD_VIEW_LR)
    assets = assets.to(dev)
    body_pose, betas, orient_init, cam_init, silhouette, joints2d = (
        as_f32(x, dev) for x in (body_pose, betas, orient_init, cam_init,
                                 silhouette, joints2d))
    if mask is not None:
        mask = as_f32(mask, dev)
    best_params, best = run_fit_loop(
        assets, {"global_orient": orient_init, "cam_wp": cam_init},
        {"body_pose": body_pose, "betas": betas}, _assemble_broad,
        silhouette, joints2d, fit_cfg, mask, mesh=mesh)
    translation = weak_perspective_to_translation(
        best_params["cam_wp"], fit_cfg.focal_length, fit_cfg.proxy_wh)
    return FitResult(
        body_pose=body_pose,
        global_orient=best_params["global_orient"],
        betas=betas,
        cam_wp=best_params["cam_wp"],
        translation=translation,
        silh_iou=best["iou"],
        joint_err=best["joint_err"],
        init_silh_iou=best["init_iou"],
        init_joint_err=best["init_joint_err"],
        best_iter=best["iter"],
    )
