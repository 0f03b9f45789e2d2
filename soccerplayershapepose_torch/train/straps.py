"""Held-out synthetic evaluation of the SMPL regressor (STRAPS recipe).

Counterpart of the evaluation half of
``soccerplayershapepose_tpu/train/straps.py``: synthetic crops from random
SMPL bodies (``train/synth.py``, two z-buffer passes through K3 on the
card), optionally corrupted like a detector's output, the proxy (18
channels [sil, heatmaps], or with the ground-truth IUV image of
:func:`gt_iuv_image` 21 [sil, heatmaps, IUV] or 20 [heatmaps, IUV]; the
regressor's input width chooses), the regressor, and the reference's
metric family: PVE / PVE-SC / PVE-PA,
PVE-T / PVE-T-SC (T-pose) and MPJPE / MPJPE-SC / MPJPE-PA in mm over the
COCO joints, and the 2-D joint error in 512² proxy pixels.

:func:`evaluate_regressor_e2e` is the deployment-condition evaluation:
domain-randomised RGB crops with occluders go through ProxyNet and the
extractor (``pipeline/extract.py``), and the extracted silhouette and
keypoints (and its IUV for a 20- or 21-channel regressor), not the ground
truth, build the regressor's proxy; crops whose extraction fails are left
out and counted. :func:`expand_regressor_channels` turns the committed
18-channel weights into a 20- or 21-channel warm start.

:func:`evaluate_fit_3d` is the GT-3D benchmark of the single-view fit: the
regressor's init and the fit from it (:func:`synth_fit_batch`'s corrupted
silhouette and keypoints as the fit's targets), each against the
generating parameters.

Randomness is explicit, as in ``train/synth.py``: samplers draw into
NamedTuples and the batch functions are deterministic in those draws.
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.nn import functional as F

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.convert import (  # noqa: F401 (re-export)
    load_regressor_weights, regressor_flat_from_state_dict)
from soccerplayershapepose_torch.fit.engine import FitConfig, FitInit
from soccerplayershapepose_torch.fit.single_view import single_view_fit
from soccerplayershapepose_torch.models.ief import default_initial_params
from soccerplayershapepose_torch.models.regressor import SingleInputRegressor
from soccerplayershapepose_torch.ops.alignment import (
    procrustes_align, scale_and_translation_align)
from soccerplayershapepose_torch.ops.camera import (
    orthographic_project, undo_keypoint_normalisation)
from soccerplayershapepose_torch.ops.rotations import rot6d_to_rotmat
from soccerplayershapepose_torch.pipeline.extract import ProxyExtractor
from soccerplayershapepose_torch.pipeline.predict import on_device
from soccerplayershapepose_torch.pipeline.proxy import (
    create_proxy_representation)
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.smpl.model import (
    smpl_forward, smpl_shape_only)
from soccerplayershapepose_torch.train.synth import (
    CropDraws, draws_to, render_crop_batch, sample_crop_draws)
from soccerplayershapepose_torch.utils import profiling
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, default_device)

# Far enough off-frame that a truncated Gaussian window (±2σ, σ = 4 px)
# never meets the image: a dropped joint's heatmap is zero.
_DROPPED_JOINT = -1.0e4
# The training-noise model of the JAX package's ``corrupt_proxy_inputs``.
DROP_P = 0.08             # per-joint probability of a missed detection
MAX_CUTOUTS = 2
CUTOUT_P = 0.5            # probability that each cut-out is applied
CUTOUT_FRAC = 0.35        # largest cut-out side, as a share of the crop
JITTER_FRAC = 0.02        # joint jitter σ, as a share of the crop
SCORE_NOISE = 0.75        # σ of the noise on the confidence logits


class CorruptionDraws(NamedTuple):
    """The random draws of ``corrupt_proxy_inputs`` for one batch."""
    jitter: torch.Tensor       # (B, 17, 2) standard normal
    dropped: torch.Tensor      # (B, 17) bool: missed detections
    score_noise: torch.Tensor  # (B, 17) standard normal
    cut_active: torch.Tensor   # (C, B) bool: cut-out c is applied
    cut_centre: torch.Tensor   # (C, B, 2) U[0, wh) px
    cut_half: torch.Tensor     # (C, B, 2) U[0.03·wh, CUTOUT_FRAC·wh/2) px


def sample_corruption_draws(gen: torch.Generator, b: int, wh: int,
                            drop_p: float = DROP_P) -> CorruptionDraws:
    """The draws of one batch's corruption. ``drop_p`` is the per-joint
    probability of a missed detection; the fit targets take 0.0. The
    dropout uniforms are drawn whatever it is, so the other draws do not
    shift (as JAX's ``bernoulli(key, 0.0)`` draws all False from an
    unchanged key stream)."""
    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=gen.device) \
            * (hi - lo) + lo

    c, j = MAX_CUTOUTS, cfg.NUM_KPRCNN_JOINTS
    return CorruptionDraws(
        jitter=torch.randn((b, j, 2), generator=gen, device=gen.device),
        dropped=uniform((b, j), 0.0, 1.0) < drop_p,
        score_noise=torch.randn((b, j), generator=gen, device=gen.device),
        cut_active=uniform((c, b), 0.0, 1.0) < CUTOUT_P,
        cut_centre=uniform((c, b, 2), 0.0, float(wh)),
        cut_half=uniform((c, b, 2), 0.03 * wh, 0.5 * CUTOUT_FRAC * wh))


def corrupt_proxy_inputs(draws: CorruptionDraws, silhouette: torch.Tensor,
                         joints2d: torch.Tensor, return_scores: bool = False):
    """Detector-noise augmentation of clean proxy inputs: per-joint
    Gaussian jitter (σ = ``JITTER_FRAC``·wh), per-joint dropout (the joint
    moves off-frame, its heatmap is zero) and rectangular cut-outs zeroed
    out of the silhouette. With ``return_scores`` also per-joint confidence
    scores, a noisy correlate of the injected error (dropped joints score
    0). Returns ``(silhouette', joints2d'[, scores])``."""
    wh = silhouette.shape[-1]
    jit_px = draws.jitter * (JITTER_FRAC * wh)
    joints = joints2d + jit_px
    joints = torch.where(draws.dropped[..., None], _DROPPED_JOINT, joints)
    ys = torch.arange(wh, dtype=torch.float32,
                      device=silhouette.device).reshape(1, wh, 1)
    xs = ys.reshape(1, 1, wh)
    sil = silhouette
    for active, centre, half in zip(draws.cut_active, draws.cut_centre,
                                    draws.cut_half):
        inside = ((torch.abs(xs - centre[:, 0, None, None])
                   < half[:, 0, None, None])
                  & (torch.abs(ys - centre[:, 1, None, None])
                     < half[:, 1, None, None]))
        sil = torch.where(active[:, None, None] & inside, 0.0, sil)
    if not return_scores:
        return sil, joints
    err_norm = torch.linalg.vector_norm(jit_px, dim=-1) \
        / max(JITTER_FRAC * wh, 1e-6)
    scores = torch.sigmoid(2.0 - err_norm + draws.score_noise * SCORE_NOISE)
    return sil, joints, torch.where(draws.dropped, 0.0, scores)


def gt_iuv_image(part: torch.Tensor, uv: torch.Tensor, wh: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-4 ground-truth part (B, h, w) and UV (B, h, w, 2) maps →
    (B, wh, wh, 3) IUV image in [0, 1], the deployment convention (the
    reference divides its stored DensePose PNG by 255): channel 0 is the
    part index / 255, channels 1-2 U and V (0 on background). Part labels
    upsample nearest, UV bilinearly (half-pixel centres). ``mask``
    (B, wh, wh) multiplies the image: a cut-out silhouette hits the IUV
    too."""
    part_f = F.interpolate(part.to(torch.float32)[:, None], size=(wh, wh),
                           mode="nearest")[:, 0]
    uv_f = F.interpolate(uv.permute(0, 3, 1, 2), size=(wh, wh),
                         mode="bilinear", align_corners=False)
    fg = (part_f > 0).to(torch.float32)
    iuv = torch.stack([part_f, uv_f[:, 0] * 255.0 * fg,
                       uv_f[:, 1] * 255.0 * fg], dim=-1) / 255.0
    if mask is not None:
        iuv = iuv * mask[..., None]
    return iuv


def _build_proxy(sil, joints, wh: int, proxy_channels: int, iuv=None):
    """The proxy of ``proxy_channels`` channels: 18 [sil, heatmaps], 21
    [sil, heatmaps, IUV] or 20 [heatmaps, IUV]; ``iuv`` (B, wh, wh, 3) in
    [0, 1] for the last two."""
    if proxy_channels == 18:
        return create_proxy_representation(sil, joints, in_wh=wh)
    if proxy_channels not in (20, 21):
        raise ValueError(f"no {proxy_channels}-channel proxy")
    return create_proxy_representation(
        sil, joints, in_wh=wh, iuv=iuv.permute(0, 3, 1, 2),
        include_silhouette=(proxy_channels == 21))


class RegressorDraws(NamedTuple):
    crop: CropDraws
    corruption: Optional[CorruptionDraws]


def sample_regressor_draws(gen: torch.Generator, b: int, wh: int,
                           corrupt: bool = True,
                           occluders: bool = True) -> RegressorDraws:
    return RegressorDraws(
        sample_crop_draws(gen, b, occluders=occluders),
        sample_corruption_draws(gen, b, wh) if corrupt else None)


def synth_regressor_batch(assets: SMPLAssets, draws: RegressorDraws,
                          wh: int = 512, proxy_channels: int = 18) -> dict:
    """One STRAPS batch from its draws: ``{proxy (B, C, 256, 256),
    joints2d (B, 17, 2)`` in the 512² proxy frame, ``target_pose
    (B, 24, 3, 3), target_betas (B, 10), gt_cam_wp (B, 3)}``. ``wh`` is
    the silhouette render size; the joint targets are rescaled to 512²
    whatever it is. Corruption applies when the draws carry it, and its
    cut-out silhouette masks the IUV. ``proxy_channels``: 18 [sil,
    heatmaps], 21 [sil, heatmaps, ground-truth IUV] or 20 [heatmaps,
    IUV]."""
    data = render_crop_batch(assets, draws.crop, wh, return_params=True)
    sil, joints = data["silhouette"], data["joints2d"]
    if draws.corruption is not None:
        sil, joints = corrupt_proxy_inputs(
            draws_to(draws.corruption, sil.device), sil, joints)
    iuv = None
    if proxy_channels != 18:
        iuv = gt_iuv_image(data["part"], data["uv"], wh,
                           mask=sil if draws.corruption is not None else None)
    scale = cfg.PROXY_REP_INPUT_WH / float(wh)
    return {"proxy": _build_proxy(sil, joints, wh, proxy_channels, iuv),
            "joints2d": data["joints2d"] * scale,        # clean supervision
            "target_pose": torch.cat([data["global_orient"],
                                      data["body_pose"]], dim=1),
            "target_betas": data["betas"], "gt_cam_wp": data["cam_wp"]}


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def regressor_metrics(assets: SMPLAssets, cam_wp, pose6d, betas,
                      target_pose, target_betas, target_joints2d) -> dict:
    """PVE/MPJPE-family metrics of one predicted batch (6D pose)."""
    rotmats = rot6d_to_rotmat(pose6d.reshape(-1, cfg.NUM_JOINTS, 6))
    return rotmat_metrics(assets, cam_wp, rotmats, betas, target_pose,
                          target_betas, target_joints2d)


def rotmat_metrics(assets: SMPLAssets, cam_wp, rotmats, betas, target_pose,
                   target_betas, target_joints2d) -> dict:
    """As :func:`regressor_metrics`, on (B, 24, 3, 3) rotation matrices:
    -SC is scale+translation aligned, -PA Procrustes aligned, PVE-T the
    T-pose vertex error; 3-D in mm, the 2-D joint error in 512² pixels.
    Values are 0-dim tensors."""
    pred = smpl_forward(assets, betas, rotmats[:, 1:], rotmats[:, :1])
    gt = smpl_forward(assets, target_betas, target_pose[:, 1:],
                      target_pose[:, :1])
    coco = list(cfg.ALL_JOINTS_TO_COCO_MAP)

    def mm(a, b):
        return torch.linalg.vector_norm(a - b, dim=-1).mean() * 1000.0

    pv, gv = pred.vertices, gt.vertices
    pj, gj = pred.joints[:, coco], gt.joints[:, coco]
    pvt = smpl_shape_only(assets, betas)
    gvt = smpl_shape_only(assets, target_betas)
    j2d = undo_keypoint_normalisation(
        orthographic_project(pred.joints, cam_wp)[
            :, list(cfg.SMPL_TO_KPRCNN_MAP)], cfg.PROXY_REP_INPUT_WH)
    return {
        "pve_mm": mm(pv, gv),
        "pve_sc_mm": mm(scale_and_translation_align(pv, gv), gv),
        "pve_pa_mm": mm(procrustes_align(pv, gv), gv),
        "pve_t_mm": mm(pvt, gvt),
        "pve_t_sc_mm": mm(scale_and_translation_align(pvt, gvt), gvt),
        "mpjpe_mm": mm(pj, gj),
        "mpjpe_sc_mm": mm(scale_and_translation_align(pj, gj), gj),
        "mpjpe_pa_mm": mm(procrustes_align(pj, gj), gj),
        "joints2d_l2_px": torch.linalg.vector_norm(
            j2d - target_joints2d, dim=-1).mean(),
    }


# ---------------------------------------------------------------------------
# Held-out evaluation
# ---------------------------------------------------------------------------

@torch.no_grad()
def evaluate_regressor(regressor: SingleInputRegressor, assets: SMPLAssets,
                       n_batches: int = 4, batch: int = 16, wh: int = 512,
                       corrupt: bool = False, seed: int = 10_000_000,
                       draws: Optional[Sequence[RegressorDraws]] = None,
                       proxy_fn: Optional[Callable[[dict], torch.Tensor]]
                       = None, device: DeviceLike = None) -> dict:
    """Held-out synthetic evaluation of a regressor on ``device`` (None:
    the CUDA card): the mean of each metric over ``n_batches`` batches of
    ``batch`` crops rendered at ``wh``², clean (``corrupt=False``) or under
    the training-noise model. The batches' draws come from a CPU generator
    seeded with ``seed`` unless ``draws`` (one per batch) are given.
    ``proxy_fn`` replaces the ground-truth proxy: it maps the batch dict of
    :func:`synth_regressor_batch` to the regressor's input."""
    dev = default_device(device)
    assets = on_device(assets, dev)
    regressor = regressor.to(dev).eval()
    if draws is None:
        gen = torch.Generator().manual_seed(seed)
        draws = [sample_regressor_draws(gen, batch, wh, corrupt)
                 for _ in range(n_batches)]
    init = default_initial_params(assets.mean_pose_rot6d, assets.mean_shape)
    sums: Optional[dict] = None
    for d in draws:
        b = synth_regressor_batch(assets, d, wh=wh,
                                  proxy_channels=regressor.in_channels)
        proxy = b["proxy"] if proxy_fn is None else proxy_fn(b)
        cam_wp, pose6d, betas = regressor(proxy, init)
        m = regressor_metrics(assets, cam_wp, pose6d, betas, b["target_pose"],
                              b["target_betas"], b["joints2d"])
        m = {k: float(v) for k, v in m.items()}
        sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
    out = {k: v / len(draws) for k, v in sums.items()}
    out.update(n_images=int(sum(d.crop.body.cam_wp.shape[0] for d in draws)),
               eval_wh=wh,
               corrupt_eval=any(d.corruption is not None for d in draws))
    return out


# ---------------------------------------------------------------------------
# The GT-3D benchmark of the single-view fit
# ---------------------------------------------------------------------------

def sample_fit_draws(gen: torch.Generator, b: int, wh: int,
                     corrupt: bool = True) -> RegressorDraws:
    """The draws of one :func:`synth_fit_batch`: crops with occluders and,
    with ``corrupt``, jitter, scores and cut-outs but no joint dropout (the
    fit loss takes raw coordinates without confidence gating)."""
    return RegressorDraws(
        sample_crop_draws(gen, b),
        sample_corruption_draws(gen, b, wh, drop_p=0.0) if corrupt else None)


def synth_fit_batch(assets: SMPLAssets, draws: RegressorDraws,
                    wh: int = 512) -> dict:
    """A held-out batch of the GT-3D fitting benchmark from its draws: the
    batch of :func:`synth_regressor_batch` plus the (corrupted) silhouette
    and keypoints as fit targets in the wh² render frame, the same
    observations that built the proxy. ``joints2d_fit (B, 17, 3)`` carries
    the score channel (:func:`corrupt_proxy_inputs`; 1 without
    corruption) for confidence-weighted fitting. The draws come from
    :func:`sample_fit_draws`: their ``dropped`` joints apply as drawn."""
    data = render_crop_batch(assets, draws.crop, wh, return_params=True)
    sil, joints = data["silhouette"], data["joints2d"]
    scores = torch.ones(joints.shape[:2], device=joints.device)
    if draws.corruption is not None:
        sil, joints, scores = corrupt_proxy_inputs(
            draws_to(draws.corruption, sil.device), sil, joints,
            return_scores=True)
    scale = cfg.PROXY_REP_INPUT_WH / float(wh)
    return {"proxy": create_proxy_representation(sil, joints, in_wh=wh),
            "silhouette": sil,                        # fit target (wh²)
            "joints2d_fit": torch.cat([joints, scores[..., None]], dim=-1),
            "joints2d": data["joints2d"] * scale,     # clean GT (512 px)
            "target_pose": torch.cat([data["global_orient"],
                                      data["body_pose"]], dim=1),
            "target_betas": data["betas"], "gt_cam_wp": data["cam_wp"]}


@torch.no_grad()
def infer_rotmats(regressor: SingleInputRegressor, assets: SMPLAssets,
                  proxy: torch.Tensor):
    """The regressor's ``(cam_wp (B, 3), rotmats (B, 24, 3, 3), betas
    (B, 10))`` for a batch of proxies."""
    init = default_initial_params(assets.mean_pose_rot6d, assets.mean_shape)
    cam_wp, pose6d, betas = regressor(proxy, init)
    return (cam_wp, rot6d_to_rotmat(pose6d.reshape(-1, cfg.NUM_JOINTS, 6)),
            betas)


def metrics_float(assets: SMPLAssets, *args) -> dict:
    """:func:`rotmat_metrics` as Python floats."""
    with torch.no_grad():
        return {k: float(v) for k, v in rotmat_metrics(assets, *args).items()}


def default_fit3d_config(wh: int):
    """The GT-3D benchmarks' default fit: the stage's settings at a
    min(wh, 256)² render."""
    return FitConfig(proxy_wh=wh, render_wh=min(wh, 256))


def evaluate_fit_3d(regressor: SingleInputRegressor, assets: SMPLAssets,
                    n_batches: int = 1, batch: int = 8, wh: int = 512,
                    corrupt: bool = True, fit_cfg=None,
                    seed: int = 20_000_000,
                    draws: Optional[Sequence[RegressorDraws]] = None,
                    device: DeviceLike = None) -> dict:
    """Ground-truth 3-D benchmark of the single-view fit on ``device``
    (None: the CUDA card): the PVE/MPJPE family of the regressor's init
    and of the fit from it, against the generating parameters, plus the
    fit's 2-D diagnostics (silhouette IoU, joint px error at the first and
    the best iterate), each the mean over ``n_batches`` batches of
    ``batch`` crops at ``wh``². The draws come from a CPU generator seeded
    with ``seed`` unless ``draws`` (one per batch) are given."""
    dev = default_device(device)
    assets = on_device(assets, dev)
    regressor = regressor.to(dev).eval()
    fit_cfg = fit_cfg or default_fit3d_config(wh)
    if draws is None:
        gen = torch.Generator().manual_seed(seed)
        draws = [sample_fit_draws(gen, batch, wh, corrupt)
                 for _ in range(n_batches)]
    sums: Optional[dict] = None
    for d in draws:
        b = synth_fit_batch(assets, d, wh=wh)
        cam_wp, rotmats, betas = infer_rotmats(regressor, assets, b["proxy"])
        gt = (b["target_pose"], b["target_betas"], b["joints2d"])
        m_init = metrics_float(assets, cam_wp, rotmats, betas, *gt)
        res = single_view_fit(
            assets, FitInit(body_pose=rotmats[:, 1:],
                            global_orient=rotmats[:, :1], betas=betas,
                            cam_wp=cam_wp),
            b["silhouette"], b["joints2d_fit"], fit_cfg, device=dev)
        m_fit = metrics_float(
            assets, res.cam_wp, torch.cat([res.global_orient, res.body_pose],
                                          dim=1), res.betas, *gt)
        m = {**{f"init_{k}": v for k, v in m_init.items()},
             **{f"fit_{k}": v for k, v in m_fit.items()},
             "fit_silh_iou": float(res.silh_iou.mean()),
             "init_silh_iou": float(res.init_silh_iou.mean()),
             "fit_joint_err_px": float(res.joint_err.mean()),
             "init_joint_err_px": float(res.init_joint_err.mean())}
        sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
    out = {k: v / len(draws) for k, v in sums.items()}
    out.update(n_images=int(sum(d.crop.body.cam_wp.shape[0] for d in draws)),
               eval_wh=wh,
               corrupt_eval=any(d.corruption is not None for d in draws),
               fit_iters=fit_cfg.iters)
    return out


def crop_images_u8(image: torch.Tensor) -> torch.Tensor:
    """[0, 1] float images → uint8, truncated as numpy's ``astype``."""
    return torch.clamp(image * 255.0, 0, 255).to(torch.uint8)


@torch.no_grad()
def evaluate_regressor_e2e(regressor: SingleInputRegressor,
                           extractor: ProxyExtractor, assets: SMPLAssets,
                           n_batches: int = 4, batch: int = 16,
                           wh: int = 256, seed: int = 10_000_000,
                           draws: Optional[Iterable[CropDraws]] = None,
                           stage_times: Optional[dict] = None,
                           device: DeviceLike = None) -> dict:
    """Deployment-condition held-out evaluation on ``device`` (None: the
    CUDA card): RGB crops at ``wh``² (occluders, domain randomisation) →
    ``extractor`` (on the same device) → proxy from the extracted
    silhouette and keypoints → regressor → the metrics of
    :func:`regressor_metrics` against the generating parameters, joints in
    512² pixels. Crops whose extraction fails are left out and counted in
    ``extraction_failures``; the metrics are means over the others.

    The draws are ``draws`` (one per batch) or, batch by batch, the
    geometry from a CPU generator seeded with ``seed`` (the stream of
    :func:`evaluate_regressor`) and the appearance from a generator on
    ``device`` seeded the same. ``stage_times``, a dict, receives the wall
    seconds of ``synthesis``, ``proxynet`` (forward and decoders),
    ``extraction`` (host) and ``regressor`` (proxy, regressor, metrics);
    the device is synchronised at each stage's end to read them."""
    dev = default_device(device)
    if extractor.device != dev:
        raise ValueError("the extractor runs on %s, the evaluation on %s"
                         % (extractor.device, dev))
    assets = on_device(assets, dev)
    regressor = regressor.to(dev).eval()
    if draws is None:
        gen = torch.Generator().manual_seed(seed)
        image_gen = torch.Generator(device=dev).manual_seed(seed)
        draws = (sample_crop_draws(gen, batch, image_wh=wh,
                                   image_gen=image_gen)
                 for _ in range(n_batches))
    init = default_initial_params(assets.mean_pose_rot6d, assets.mean_shape)
    scale = cfg.PROXY_REP_INPUT_WH / float(wh)
    sums: Optional[dict] = None
    n_ok = n_fail = 0
    stage = profiling.Stages(stage_times, dev, prefix="e2e.")
    for d in draws:
        with stage("synthesis"):
            data = render_crop_batch(assets, d, wh, return_params=True,
                                     with_image=True)
            images = crop_images_u8(data["image"])
        with stage("proxynet"):
            maps = extractor.forward(images)
        with stage("extraction"):
            results = extractor.pick(*maps)
            keep = [j for j, r in enumerate(results) if r[0] is not None]
            n_fail += len(results) - len(keep)
        if not keep:
            continue
        with stage("regressor"):
            n_ok += len(keep)
            sil = torch.from_numpy(np.stack([results[j][1] for j in keep]))
            kps = torch.from_numpy(np.stack([results[j][0][:, :2]
                                             for j in keep]))
            iuv = None
            if regressor.in_channels != 18:
                # The extractor's IUV is decode_iuv's (part 0..24, U, V
                # 0..255); /255 is the reference's loaded-PNG scaling. A
                # crop with no IUV gets zeros.
                iuv = torch.from_numpy(np.stack([
                    results[j][2].astype(np.float32) / 255.0
                    if results[j][2] is not None
                    else np.zeros((wh, wh, 3), np.float32)
                    for j in keep])).to(dev)
            proxy = _build_proxy(sil.to(dev), kps.to(dev), wh,
                                 regressor.in_channels, iuv)
            idx = torch.tensor(keep, device=dev)
            target_pose = torch.cat([data["global_orient"],
                                     data["body_pose"]], dim=1)[idx]
            cam_wp, pose6d, betas = regressor(proxy, init)
            m = regressor_metrics(assets, cam_wp, pose6d, betas, target_pose,
                                  data["betas"][idx],
                                  data["joints2d"][idx] * scale)
            m = {k: float(v) * len(keep) for k, v in m.items()}
            sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
    if sums is None:
        return {"extraction_failures": n_fail, "n_images": 0, "eval_wh": wh}
    out = {k: v / n_ok for k, v in sums.items()}
    out.update(n_images=n_ok, extraction_failures=n_fail, eval_wh=wh,
               via="proxynet_extractor")
    return out


class ExtractedDraws(NamedTuple):
    """The draws of one :func:`extracted_regressor_batch`: domain-randomised
    RGB crops with occluders, and the corruption of the fallback rows."""
    crop: CropDraws
    corruption: CorruptionDraws


def sample_extracted_draws(gen: torch.Generator, b: int, wh: int,
                           image_gen: Optional[torch.Generator] = None
                           ) -> ExtractedDraws:
    """The geometry and the corruption (the training noise model,
    ``DROP_P``) from ``gen``, the appearance of the wh² crops from
    ``image_gen`` (default ``gen``)."""
    crop = sample_crop_draws(gen, b, image_wh=wh, image_gen=image_gen)
    return ExtractedDraws(crop, sample_corruption_draws(gen, b, wh))


@torch.no_grad()
def extracted_regressor_batch(assets: SMPLAssets, extractor: ProxyExtractor,
                              draws: ExtractedDraws, wh: int = 256,
                              proxy_channels: int = 18,
                              return_raw: bool = False) -> dict:
    """One regressor batch whose proxies come from the perception path, on
    the extractor's device.

    The draws' RGB crops (occluders, domain randomisation; K3 twice on the
    card) go through ``extractor``, and the extracted silhouette and
    keypoints (and its IUV for 20 or 21 channels) build the proxy; the
    supervision stays the generating SMPL parameters, the joints in 512²
    pixels. A row whose extraction finds nobody falls back to the clean
    labels corrupted by the draws' corruption (:func:`corrupt_proxy_inputs`)
    and, for the IUV, to the ground-truth IUV image under that silhouette.

    ``return_raw`` returns numpy pre-proxy arrays sized for an on-disk
    cache instead (``sil`` uint8, ``kps``, ``joints2d``, ``target_pose``,
    ``target_betas``, ``gt_cam_wp``, ``iuv`` uint8 for 20 or 21 channels):
    extraction is the expensive part, so a fine-tune extracts a batch once
    and replays it (:func:`assemble_extracted_batch`).
    """
    dev = extractor.device
    assets = on_device(assets, dev)
    data = render_crop_batch(assets, draws.crop, wh, return_params=True,
                             with_image=True)
    images_u8 = crop_images_u8(data["image"])
    fb_sil, fb_joints = corrupt_proxy_inputs(
        draws_to(draws.corruption, dev), data["silhouette"],
        data["joints2d"])
    fb_iuv = None
    if proxy_channels != 18:
        fb_iuv = gt_iuv_image(data["part"], data["uv"], wh,
                              mask=fb_sil).cpu().numpy()
    fb_sil, fb_joints = fb_sil.cpu().numpy(), fb_joints.cpu().numpy()
    sils, kps, iuvs = [], [], []
    for j, (kp, sil, iuv) in enumerate(extractor(images_u8)):
        if kp is None:
            sils.append(fb_sil[j])
            kps.append(fb_joints[j])
            if fb_iuv is not None:
                iuvs.append(fb_iuv[j])
        else:
            sils.append(sil.astype(np.float32))
            kps.append(kp[:, :2].astype(np.float32))
            if fb_iuv is not None:
                iuvs.append(iuv.astype(np.float32) / 255.0
                            if iuv is not None else fb_iuv[j])
    scale = cfg.PROXY_REP_INPUT_WH / float(wh)
    target_pose = torch.cat([data["global_orient"], data["body_pose"]],
                            dim=1)
    if return_raw:
        raw = {"sil": np.stack(sils).astype(np.uint8),
               "kps": np.stack(kps).astype(np.float32),
               "joints2d": (data["joints2d"] * scale).cpu().numpy(),
               "target_pose": target_pose.cpu().numpy(),
               "target_betas": data["betas"].cpu().numpy(),
               "gt_cam_wp": data["cam_wp"].cpu().numpy()}
        if iuvs:
            raw["iuv"] = (np.stack(iuvs) * 255.0).astype(np.uint8)
        return raw
    iuv = torch.from_numpy(np.stack(iuvs)).to(dev) if iuvs else None
    proxy = _build_proxy(torch.from_numpy(np.stack(sils)).to(dev),
                         torch.from_numpy(np.stack(kps)).to(dev), wh,
                         proxy_channels, iuv)
    return {"proxy": proxy, "joints2d": data["joints2d"] * scale,
            "target_pose": target_pose, "target_betas": data["betas"],
            "gt_cam_wp": data["cam_wp"]}


def assemble_extracted_batch(raw: dict, wh: int, proxy_channels: int = 18,
                             device: DeviceLike = None) -> dict:
    """A cached :func:`extracted_regressor_batch` raw form → the training
    batch on ``device`` (None: the CUDA card); the proxy is rebuilt there
    (``pipeline/proxy.py``), cheap beside the extraction."""
    dev = default_device(device)

    def t(k, scale=1.0):
        return torch.from_numpy(np.array(raw[k], np.float32)).to(dev) / scale

    iuv = t("iuv", 255.0) if proxy_channels != 18 else None
    return {"proxy": _build_proxy(t("sil"), t("kps"), wh, proxy_channels,
                                  iuv),
            "joints2d": t("joints2d"), "target_pose": t("target_pose"),
            "target_betas": t("target_betas"), "gt_cam_wp": t("gt_cam_wp")}


def expand_regressor_channels(src_path: str, dst_path: str,
                              proxy_channels: int) -> None:
    """18-channel regressor weights (a flax-layout npz) → a 20- or
    21-channel warm start at ``dst_path``. Only the stem convolution reads
    the proxy's channels; every other variable is copied as it is. The new
    IUV channels get zero kernel slices, so the 21-channel net computes
    what the 18-channel one does; the 20-channel one drops the silhouette
    channel (kernel slices 1..17 move to the heatmaps' places 0..16)."""
    with np.load(src_path) as z:
        flat = {k: z[k] for k in z.files}
    key = "params/ResNet_0/Conv_0/kernel"
    k = flat[key]                                       # (7, 7, 18, 64)
    if k.shape[2] != 18:
        raise ValueError(f"{src_path}: stem kernel {k.shape}, not 18 inputs")
    new = np.zeros(k.shape[:2] + (proxy_channels, k.shape[3]), k.dtype)
    if proxy_channels == 21:        # [sil, 17 heatmaps, IUV]
        new[:, :, :18] = k
    elif proxy_channels == 20:      # [17 heatmaps, IUV]
        new[:, :, :17] = k[:, :, 1:18]
    else:
        raise ValueError(proxy_channels)
    flat[key] = new
    np.savez(dst_path, **flat)


def save_regressor_weights(path: str, regressor: SingleInputRegressor,
                           dtype=None, compress: bool = False) -> None:
    """The regressor's inference weights (parameters and BN statistics) as
    the flat flax npz (``params/ResNet_0/Conv_0/kernel`` HWIO, …) that
    ``convert.load_regressor_weights`` and the JAX package both read.
    ``dtype`` (e.g. ``np.float16``) casts the fp32 arrays; ``compress``
    writes ``np.savez_compressed``. The reader is
    :func:`load_regressor_weights` (``convert.load_regressor_weights``)."""
    flat = regressor_flat_from_state_dict(regressor.state_dict(),
                                          regressor.resnet_layers)
    if dtype is not None:
        flat = {k: v.astype(dtype) if v.dtype == np.float32 else v
                for k, v in flat.items()}
    (np.savez_compressed if compress else np.savez)(path, **flat)

