"""GT-3D benchmarks of the multi-view and the track fits.

Counterpart of ``soccerplayershapepose_tpu/train/fit3d.py``. One view
cannot constrain the depth-axis pose; the reference's own answers are the
multi-view alternation (per-view cameras, a shared pose and shape across
views) and a shape shared along a clip. These benchmarks measure, against
the scene factory's generating parameters, what each does to the 3-D
error:

* multi-view, three arms on the same players: the regressor's one-shot
  init per view, the single-view fit on view 0, the multi-view fit across
  all V views;
* track: the per-frame init against the shared-betas track fit over T
  frames.

The observations are corrupted over the flattened B·V (or B·T) rows with
jitter, scores and cut-outs but no joint dropout; the scores ride along as
the fit targets' third channel. Draws are explicit: ``draws=`` (one per
batch), else a CPU generator seeded with ``seed``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.fit.engine import FitInit
from soccerplayershapepose_torch.fit.multi_view import (
    MultiViewInit, multi_view_fit)
from soccerplayershapepose_torch.fit.single_view import single_view_fit
from soccerplayershapepose_torch.fit.track import TrackInit, track_fit
from soccerplayershapepose_torch.models.regressor import SingleInputRegressor
from soccerplayershapepose_torch.pipeline.predict import on_device
from soccerplayershapepose_torch.pipeline.proxy import (
    create_proxy_representation)
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.train.scenes import (
    SceneViewsDraws, TrackDraws, sample_scene_views_draws,
    sample_track_draws, synth_scene_views, synth_track_views)
from soccerplayershapepose_torch.train.straps import (
    CorruptionDraws, corrupt_proxy_inputs, default_fit3d_config,
    infer_rotmats, metrics_float, sample_corruption_draws)
from soccerplayershapepose_torch.train.synth import draws_to
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, default_device)

MULTIVIEW_NOTE = ("init/sv metrics: per-view one-shot and view-0 100-iter "
                  "fit; mv: shared pose+betas across views with per-view "
                  "cam/orient (player_recon.py:1568-1999)")
TRACK_NOTE = ("track fit: one shared betas per player over the clip, "
              "per-frame pose/orient/cam (fit/track.py; reference "
              "predict_3D clip fitting)")


class MultiViewEvalDraws(NamedTuple):
    scene: SceneViewsDraws                 # no broad view, no images
    corruption: Optional[CorruptionDraws]  # over the B·V rows, no dropout


class TrackEvalDraws(NamedTuple):
    track: TrackDraws                      # no images
    corruption: Optional[CorruptionDraws]  # over the B·T rows, no dropout


def sample_multiview_eval_draws(gen: torch.Generator, batch: int,
                                n_views: int, wh: int,
                                corrupt: bool = True) -> MultiViewEvalDraws:
    return MultiViewEvalDraws(
        sample_scene_views_draws(gen, batch, n_views, broad=False),
        sample_corruption_draws(gen, batch * n_views, wh, drop_p=0.0)
        if corrupt else None)


def sample_track_eval_draws(gen: torch.Generator, batch: int, n_frames: int,
                            wh: int, corrupt: bool = True) -> TrackEvalDraws:
    return TrackEvalDraws(
        sample_track_draws(gen, batch, n_frames),
        sample_corruption_draws(gen, batch * n_frames, wh, drop_p=0.0)
        if corrupt else None)


def _flat2(x: torch.Tensor) -> torch.Tensor:
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _fit_targets(sil: torch.Tensor, j2d_clean: torch.Tensor,
                 corruption: Optional[CorruptionDraws]):
    """(B, R, wh, wh) silhouettes and (B, R, 17, 2) joints → the fit
    targets: the silhouettes corrupted over the B·R rows and (B, R, 17, 3)
    joints with their scores (1 without corruption)."""
    if corruption is None:
        ones = torch.ones(j2d_clean.shape[:-1] + (1,),
                          device=j2d_clean.device)
        return sil, torch.cat([j2d_clean, ones], dim=-1)
    s_f, j_f, sc_f = corrupt_proxy_inputs(
        draws_to(corruption, sil.device), _flat2(sil), _flat2(j2d_clean),
        return_scores=True)
    return (s_f.reshape(sil.shape),
            torch.cat([j_f, sc_f[..., None]], dim=-1)
            .reshape(j2d_clean.shape[:-1] + (3,)))


def _prefixed(prefix: str, m: dict) -> dict:
    return {f"{prefix}_{k}": v for k, v in m.items()}


def evaluate_fit_3d_multiview(regressor: SingleInputRegressor,
                              assets: SMPLAssets, n_batches: int = 2,
                              batch: int = 8, n_views: int = 3,
                              wh: int = 512, corrupt: bool = True,
                              fit_cfg=None,
                              rounds: int = cfg.MULTI_VIEW_ROUNDS,
                              iters_per_phase: int = cfg.MULTI_VIEW_ITERS,
                              seed: int = 30_000_000,
                              draws: Optional[Sequence[MultiViewEvalDraws]]
                              = None, device: DeviceLike = None) -> dict:
    """GT-3D on ``device`` (None: the CUDA card): init vs the single-view
    fit on view 0 vs the multi-view fit, on the same players. The init and
    multi-view metrics are means over the B·V rows (the shared pose
    repeated across the views, each view with its own GT orient); the
    single-view arm's over the B players of view 0."""
    dev = default_device(device)
    assets = on_device(assets, dev)
    regressor = regressor.to(dev).eval()
    fit_cfg = fit_cfg or default_fit3d_config(wh)
    scale = cfg.PROXY_REP_INPUT_WH / float(wh)
    if draws is None:
        gen = torch.Generator().manual_seed(seed)
        draws = [sample_multiview_eval_draws(gen, batch, n_views, wh,
                                             corrupt)
                 for _ in range(n_batches)]
    sums: Optional[dict] = None
    for d in draws:
        data = synth_scene_views(assets, d.scene, wh=wh)
        scene, views = data["scene"], data["views"]
        sil = torch.stack([v["silhouette"] for v in views], dim=1)
        j2d_clean = torch.stack([v["joints2d"] for v in views], dim=1)
        gt_orient = torch.stack([v["global_orient"] for v in views], dim=1)
        b, v = sil.shape[:2]
        sil, j2d_fit = _fit_targets(sil, j2d_clean, d.corruption)
        gt_pose = torch.cat([gt_orient, scene["body_pose"][:, None].expand(
            b, v, 23, 3, 3)], dim=2)                          # (B, V, 24, ..)
        gt_betas = scene["betas"][:, None].expand(b, v, 10)
        gt_j2d = j2d_clean * scale
        gt_flat = (_flat2(gt_pose), _flat2(gt_betas), _flat2(gt_j2d))

        proxy = create_proxy_representation(
            _flat2(sil), _flat2(j2d_fit)[..., :2], in_wh=wh)
        cam_f, rot_f, betas_f = infer_rotmats(regressor, assets, proxy)
        m_init = metrics_float(assets, cam_f, rot_f, betas_f, *gt_flat)
        rot = rot_f.reshape(b, v, 24, 3, 3)
        betas_v, cam_v = betas_f.reshape(b, v, 10), cam_f.reshape(b, v, 3)

        # Arm 2: the single-view fit on view 0.
        res_sv = single_view_fit(
            assets, FitInit(body_pose=rot[:, 0, 1:],
                            global_orient=rot[:, 0, :1],
                            betas=betas_v[:, 0], cam_wp=cam_v[:, 0]),
            sil[:, 0], j2d_fit[:, 0], fit_cfg, device=dev)
        m_sv = metrics_float(
            assets, res_sv.cam_wp,
            torch.cat([res_sv.global_orient, res_sv.body_pose], dim=1),
            res_sv.betas, gt_pose[:, 0], gt_betas[:, 0], gt_j2d[:, 0])

        # Arm 3: the multi-view alternation across all V views.
        res_mv = multi_view_fit(
            assets, MultiViewInit(body_pose=rot[:, :, 1:],
                                  global_orient=rot[:, :, :1],
                                  betas=betas_v, cam_wp=cam_v),
            sil, j2d_fit, fit_cfg, rounds=rounds,
            iters_per_phase=iters_per_phase, device=dev)
        mv_pose = torch.cat([
            _flat2(res_mv.global_orient),
            _flat2(res_mv.body_pose[:, None].expand(b, v, 23, 3, 3))], dim=1)
        m_mv = metrics_float(assets, _flat2(res_mv.cam_wp), mv_pose,
                             res_mv.betas.repeat_interleave(v, dim=0),
                             *gt_flat)

        m = {**_prefixed("init", m_init), **_prefixed("sv", m_sv),
             **_prefixed("mv", m_mv),
             "mv_silh_iou": float(res_mv.silh_iou.mean()),
             "sv_silh_iou": float(res_sv.silh_iou.mean())}
        sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
    out = {k: x / len(draws) for k, x in sums.items()}
    out.update(n_players=int(sum(d.scene.scene.shape_noise.shape[0]
                                 for d in draws)),
               n_views=len(draws[0].scene.views), eval_wh=wh,
               corrupt_eval=any(d.corruption is not None for d in draws),
               rounds=rounds, iters_per_phase=iters_per_phase,
               note=MULTIVIEW_NOTE)
    return out


def evaluate_fit_3d_track(regressor: SingleInputRegressor,
                          assets: SMPLAssets, n_batches: int = 2,
                          batch: int = 4, n_frames: int = 8, wh: int = 512,
                          corrupt: bool = True, fit_cfg=None,
                          seed: int = 40_000_000,
                          draws: Optional[Sequence[TrackEvalDraws]] = None,
                          device: DeviceLike = None) -> dict:
    """GT-3D on ``device`` (None: the CUDA card): the per-frame init vs
    the shared-betas track fit, the 3-D metric family over all B·T frames
    (PVE-T against each player's fixed GT betas shows the shape
    consistency the track enforces)."""
    dev = default_device(device)
    assets = on_device(assets, dev)
    regressor = regressor.to(dev).eval()
    fit_cfg = fit_cfg or default_fit3d_config(wh)
    scale = cfg.PROXY_REP_INPUT_WH / float(wh)
    if draws is None:
        gen = torch.Generator().manual_seed(seed)
        draws = [sample_track_eval_draws(gen, batch, n_frames, wh, corrupt)
                 for _ in range(n_batches)]
    sums: Optional[dict] = None
    for d in draws:
        data = synth_track_views(assets, d.track, wh=wh)
        j2d_clean = data["joints2d"]
        b, t = j2d_clean.shape[:2]
        sil, j2d_fit = _fit_targets(data["silhouette"], j2d_clean,
                                    d.corruption)
        gt_pose = torch.cat([data["global_orient"], data["body_pose"]],
                            dim=2)                            # (B, T, 24, ..)
        gt_betas = data["betas"][:, None].expand(b, t, 10)
        gt_flat = (_flat2(gt_pose), _flat2(gt_betas),
                   _flat2(j2d_clean * scale))

        proxy = create_proxy_representation(
            _flat2(sil), _flat2(j2d_fit)[..., :2], in_wh=wh)
        cam_f, rot_f, betas_f = infer_rotmats(regressor, assets, proxy)
        m_init = metrics_float(assets, cam_f, rot_f, betas_f, *gt_flat)
        rot = rot_f.reshape(b, t, 24, 3, 3)
        res = track_fit(
            assets, TrackInit(body_pose=rot[:, :, 1:],
                              global_orient=rot[:, :, :1],
                              betas=betas_f.reshape(b, t, 10),
                              cam_wp=cam_f.reshape(b, t, 3)),
            sil, j2d_fit, fit_cfg, device=dev)
        fit_pose = torch.cat([_flat2(res.global_orient),
                              _flat2(res.body_pose)], dim=1)
        m_fit = metrics_float(assets, _flat2(res.cam_wp), fit_pose,
                              res.betas.repeat_interleave(t, dim=0),
                              *gt_flat)
        m = {**_prefixed("init", m_init), **_prefixed("fit", m_fit),
             "fit_silh_iou": float(res.silh_iou.mean())}
        sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
    out = {k: x / len(draws) for k, x in sums.items()}
    out.update(n_players=int(sum(d.track.shape_noise.shape[0]
                                 for d in draws)),
               n_frames=int(draws[0].track.scale_noise.shape[1]),
               eval_wh=wh,
               corrupt_eval=any(d.corruption is not None for d in draws),
               fit_iters=fit_cfg.iters, note=TRACK_NOTE)
    return out
