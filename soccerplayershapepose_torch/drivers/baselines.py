"""Evaluation of the baseline models' predictions (HMR, SPIN, PARE).

Counterpart of ``soccerplayershapepose_tpu/drivers/baselines.py``, the role
of the reference's ``hmr.py``: external models' per-player predictions
(HMR ``.npy`` [cam | 72 axis-angle pose | 10 betas], SPIN/PARE ``.npz``
{pred_rotmat, pred_betas, pred_camera}) are evaluated against the proxies
as they are, and after the camera and global-orient optimisation the
pipeline applies to its own regressor's output: per view, across views
(fit one view, measure another), and in the multi-view fit with or without
a single-view initialisation. :func:`calc_result` rolls a result tree's
``metrics.xml`` files up.

Each function is a thin layer over the fitting engine: the broadcast-view
fit (``fit/broad_view.py``), the multi-view fit (``fit/multi_view.py``) and
``fit/engine.py:fit_metrics``, so the silhouette is rendered by K1 (and its
gradient by K2) on the card. Each runs on ``device`` (None: the CUDA
card); the results are numpy.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.fit.broad_view import broad_view_fit
from soccerplayershapepose_torch.fit.engine import (
    FitConfig, FitInit, fit_metrics)
from soccerplayershapepose_torch.fit.multi_view import (
    MultiViewInit, multi_view_fit)
from soccerplayershapepose_torch.io import formats as io
from soccerplayershapepose_torch.ops.rotations import batch_rodrigues
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, as_f32, default_device)


def load_baseline_prediction(path: str) -> dict:
    """An HMR ``.npy`` or a SPIN/PARE ``.npz`` → ``{pose_rotmats (1, 24, 3,
    3), betas (1, 10), cam_wp (1, 3)}`` (numpy); HMR's axis-angle pose goes
    through ``batch_rodrigues`` in fp32."""
    if path.endswith(".npy"):
        raw = io.read_hmr_prediction(path)
        rotmats = batch_rodrigues(torch.from_numpy(
            raw["pose_axis_angle"].astype(np.float32))).numpy()
        return {"pose_rotmats": rotmats, "betas": raw["betas"],
                "cam_wp": raw["cam_wp"]}
    return io.read_spin_prediction(path)


def _stack(predictions: List[dict], key: str) -> np.ndarray:
    return np.concatenate([p[key] for p in predictions]).astype(np.float32)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _broad_cfg() -> FitConfig:
    return FitConfig(iters=cfg.BROAD_VIEW_ITERS, lr=cfg.BROAD_VIEW_LR)


def evaluate_baseline_2d(assets: SMPLAssets, predictions: List[dict],
                         silhouettes: np.ndarray, joints2d: np.ndarray,
                         fit_cfg: Optional[FitConfig] = None,
                         optimize: bool = True,
                         device: DeviceLike = None) -> dict:
    """Evaluate the predictions (one dict per player, see
    :func:`load_baseline_prediction`) against the proxies, silhouettes
    (B, wh, wh) and joints (B, 17, 2|3) px; with ``optimize`` after the
    camera and global-orient fit (``broad_view_fit``; default: its
    iterations and lr). Returns per-player ``init_iou``, ``init_err``,
    ``opt_iou``, ``opt_err`` (without ``optimize`` the last two repeat the
    first) and with ``optimize`` the fit's ``result``."""
    dev = default_device(device)
    fit_cfg = fit_cfg or _broad_cfg()
    pose = as_f32(_stack(predictions, "pose_rotmats"), dev)
    betas = as_f32(_stack(predictions, "betas"), dev)
    cam = as_f32(_stack(predictions, "cam_wp"), dev)
    if optimize:
        res = broad_view_fit(assets, pose[:, 1:], betas, pose[:, :1], cam,
                             silhouettes, joints2d, fit_cfg, device=dev)
        return {"init_iou": _np(res.init_silh_iou),
                "init_err": _np(res.init_joint_err),
                "opt_iou": _np(res.silh_iou), "opt_err": _np(res.joint_err),
                "result": res}
    m = fit_metrics(assets.to(dev),
                    FitInit(body_pose=pose[:, 1:], global_orient=pose[:, :1],
                            betas=betas, cam_wp=cam),
                    as_f32(silhouettes, dev), as_f32(joints2d, dev), fit_cfg)
    return {"init_iou": _np(m["silh_iou"]), "init_err": _np(m["joint_err"]),
            "opt_iou": _np(m["silh_iou"]), "opt_err": _np(m["joint_err"])}


def calc_result(result_root: str) -> Tuple[float, float, int]:
    """(mean silhouette IoU, mean joint error, players) over a result
    tree's ``metrics.xml`` files."""
    agg = io.calc_metrics(result_root)
    return agg["mean_silh_iou"], agg["mean_joint_err"], agg["num_players"]


def evaluate_baseline_oneview(assets: SMPLAssets, predictions: List[dict],
                              silhouettes: np.ndarray, joints2d: np.ndarray,
                              fit_cfg: Optional[FitConfig] = None,
                              device: DeviceLike = None) -> dict:
    """The single-view-only evaluation: each view's camera and orient
    optimised on its own; :func:`evaluate_baseline_2d` with
    ``optimize``, kept as the reference's named variant."""
    return evaluate_baseline_2d(assets, predictions, silhouettes, joints2d,
                                fit_cfg=fit_cfg, optimize=True, device=device)


def evaluate_baseline_cross(assets: SMPLAssets, predictions: List[dict],
                            silhouettes: np.ndarray, joints2d: np.ndarray,
                            fit_view: int, eval_view: int, n_views: int,
                            fit_cfg: Optional[FitConfig] = None,
                            device: DeviceLike = None) -> dict:
    """The cross-view evaluation: camera and orient fitted on
    ``fit_view``'s proxies, the fitted parameters measured on
    ``eval_view``'s. ``predictions`` one per player; silhouettes (P, V, wh,
    wh), joints (P, V, 17, 2|3). Returns per-player ``silh_iou`` and
    ``joint_err`` on the evaluated view."""
    dev = default_device(device)
    fit_cfg = fit_cfg or _broad_cfg()
    assert fit_view < n_views and eval_view < n_views
    fitted = evaluate_baseline_2d(
        assets, predictions, silhouettes[:, fit_view], joints2d[:, fit_view],
        fit_cfg=fit_cfg, optimize=True, device=dev)
    res = fitted["result"]
    m = fit_metrics(
        assets.to(dev),
        FitInit(body_pose=res.body_pose, global_orient=res.global_orient,
                betas=res.betas, cam_wp=res.cam_wp),
        as_f32(silhouettes[:, eval_view], dev),
        as_f32(joints2d[:, eval_view], dev), fit_cfg)
    return {"fit_view": fit_view, "eval_view": eval_view,
            "silh_iou": _np(m["silh_iou"]), "joint_err": _np(m["joint_err"])}


def multi_view_optimization_multi(assets: SMPLAssets,
                                  predictions: List[dict],
                                  silhouettes: np.ndarray,
                                  joints2d: np.ndarray,
                                  single_view_init: bool = True,
                                  fit_cfg: Optional[FitConfig] = None,
                                  rounds: int = cfg.MULTI_VIEW_ROUNDS,
                                  iters_per_phase: int = cfg.MULTI_VIEW_ITERS,
                                  device: DeviceLike = None) -> dict:
    """The multi-view fit of the predictions (one per player, its pose
    shared across the views): with ``single_view_init`` each view's camera
    and orient are first fitted alone (the broadcast-view fit's iterations
    and lr, the silhouette settings of ``fit_cfg``), else the prediction
    seeds every view. Silhouettes (P, V, wh, wh), joints (P, V, 17, 2|3).
    Returns the fit's ``result`` and per-view ``silh_iou``, ``joint_err``
    (P, V)."""
    dev = default_device(device)
    fit_cfg = fit_cfg or FitConfig(iters=iters_per_phase)
    p, v = silhouettes.shape[:2]
    pose = _stack(predictions, "pose_rotmats")                # (P, 24, 3, 3)
    betas = _stack(predictions, "betas")
    cam = _stack(predictions, "cam_wp")
    body = np.repeat(pose[:, None, 1:], v, axis=1)
    orient = np.repeat(pose[:, None, :1], v, axis=1)
    betas_v = np.repeat(betas[:, None], v, axis=1)
    cam_v = np.repeat(cam[:, None], v, axis=1)
    if single_view_init:
        flat_pred = [{"pose_rotmats": pose[i:i + 1], "betas": betas[i:i + 1],
                      "cam_wp": cam[i:i + 1]}
                     for i in range(p) for _ in range(v)]
        sv = evaluate_baseline_2d(
            assets, flat_pred,
            silhouettes.reshape(p * v, *silhouettes.shape[2:]),
            joints2d.reshape(p * v, *joints2d.shape[2:]),
            fit_cfg=FitConfig(iters=cfg.BROAD_VIEW_ITERS,
                              lr=cfg.BROAD_VIEW_LR,
                              use_silhouette=fit_cfg.use_silhouette,
                              render_wh=fit_cfg.render_wh,
                              silhouette_metrics=fit_cfg.silhouette_metrics),
            optimize=True, device=dev)
        res = sv["result"]
        orient = _np(res.global_orient).reshape(p, v, 1, 3, 3)
        cam_v = _np(res.cam_wp).reshape(p, v, 3)
    init = MultiViewInit(body_pose=body, global_orient=orient,
                         betas=betas_v, cam_wp=cam_v)
    res = multi_view_fit(assets, init, silhouettes, joints2d, fit_cfg,
                         rounds=rounds, iters_per_phase=iters_per_phase,
                         device=dev)
    return {"result": res, "silh_iou": _np(res.silh_iou),
            "joint_err": _np(res.joint_err)}
