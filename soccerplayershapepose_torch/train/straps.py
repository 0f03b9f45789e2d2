"""Held-out synthetic evaluation of the SMPL regressor (STRAPS recipe).

Counterpart of the evaluation half of
``soccerplayershapepose_tpu/train/straps.py``: synthetic crops from random
SMPL bodies (``train/synth.py``, two z-buffer passes through K3 on the
card), optionally corrupted like a detector's output, the 18-channel proxy,
the regressor, and the reference's metric family: PVE / PVE-SC / PVE-PA,
PVE-T / PVE-T-SC (T-pose) and MPJPE / MPJPE-SC / MPJPE-PA in mm over the
COCO joints, and the 2-D joint error in 512² proxy pixels.

:func:`evaluate_regressor_e2e` is the deployment-condition evaluation:
domain-randomised RGB crops with occluders go through ProxyNet and the
extractor (``pipeline/extract.py``), and the extracted silhouette and
keypoints, not the ground truth, build the regressor's proxy; crops whose
extraction fails are left out and counted.

Randomness is explicit, as in ``train/synth.py``: samplers draw into
NamedTuples and the batch functions are deterministic in those draws.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from soccerplayershapepose_torch import config as cfg
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


def sample_corruption_draws(gen: torch.Generator, b: int,
                            wh: int) -> CorruptionDraws:
    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=gen.device) \
            * (hi - lo) + lo

    c, j = MAX_CUTOUTS, cfg.NUM_KPRCNN_JOINTS
    return CorruptionDraws(
        jitter=torch.randn((b, j, 2), generator=gen, device=gen.device),
        dropped=uniform((b, j), 0.0, 1.0) < DROP_P,
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


def _build_proxy(sil, joints, wh: int, proxy_channels: int):
    """The 18-channel proxy [sil, heatmaps]; the IUV variants (20, 21) need
    the part/UV image of a later slice."""
    if proxy_channels != 18:
        raise NotImplementedError(
            f"only the 18-channel proxy is ported, got {proxy_channels}")
    return create_proxy_representation(sil, joints, in_wh=wh)


class RegressorDraws(NamedTuple):
    crop: CropDraws
    corruption: Optional[CorruptionDraws]


def sample_regressor_draws(gen: torch.Generator, b: int, wh: int,
                           corrupt: bool = True) -> RegressorDraws:
    return RegressorDraws(
        sample_crop_draws(gen, b),
        sample_corruption_draws(gen, b, wh) if corrupt else None)


def synth_regressor_batch(assets: SMPLAssets, draws: RegressorDraws,
                          wh: int = 512, proxy_channels: int = 18) -> dict:
    """One STRAPS batch from its draws: ``{proxy (B, C, 256, 256),
    joints2d (B, 17, 2)`` in the 512² proxy frame, ``target_pose
    (B, 24, 3, 3), target_betas (B, 10), gt_cam_wp (B, 3)}``. ``wh`` is
    the silhouette render size; the joint targets are rescaled to 512²
    whatever it is. Corruption applies when the draws carry it."""
    data = render_crop_batch(assets, draws.crop, wh, return_params=True)
    sil, joints = data["silhouette"], data["joints2d"]
    if draws.corruption is not None:
        sil, joints = corrupt_proxy_inputs(
            draws_to(draws.corruption, sil.device), sil, joints)
    scale = cfg.PROXY_REP_INPUT_WH / float(wh)
    return {"proxy": _build_proxy(sil, joints, wh, proxy_channels),
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


def crop_images_u8(image: torch.Tensor) -> torch.Tensor:
    """[0, 1] float images → uint8, truncated as numpy's ``astype``."""
    return torch.clamp(image * 255.0, 0, 255).to(torch.uint8)


def _lap(times: Optional[dict], stage: str, t0: float,
         dev: torch.device) -> float:
    """Add the wall time since ``t0`` to ``times[stage]`` (after the
    device's queued work) and return the time now; nothing without
    ``times``."""
    if times is None:
        return t0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = time.perf_counter()
    times[stage] = times.get(stage, 0.0) + t - t0
    return t


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
    t = _lap(stage_times, "synthesis", time.perf_counter(), dev)
    for d in draws:
        data = render_crop_batch(assets, d, wh, return_params=True,
                                 with_image=True)
        images = crop_images_u8(data["image"])
        t = _lap(stage_times, "synthesis", t, dev)
        maps = extractor.forward(images)
        t = _lap(stage_times, "proxynet", t, dev)
        results = extractor.pick(*maps)
        keep = [j for j, r in enumerate(results) if r[0] is not None]
        n_fail += len(results) - len(keep)
        t = _lap(stage_times, "extraction", t, dev)
        if not keep:
            continue
        n_ok += len(keep)
        sil = torch.from_numpy(np.stack([results[j][1] for j in keep]))
        kps = torch.from_numpy(np.stack([results[j][0][:, :2] for j in keep]))
        proxy = _build_proxy(sil.to(dev), kps.to(dev), wh,
                             regressor.in_channels)
        idx = torch.tensor(keep, device=dev)
        target_pose = torch.cat([data["global_orient"], data["body_pose"]],
                                dim=1)[idx]
        cam_wp, pose6d, betas = regressor(proxy, init)
        m = regressor_metrics(assets, cam_wp, pose6d, betas, target_pose,
                              data["betas"][idx], data["joints2d"][idx] * scale)
        m = {k: float(v) * len(keep) for k, v in m.items()}
        sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
        t = _lap(stage_times, "regressor", t, dev)
    if sums is None:
        return {"extraction_failures": n_fail, "n_images": 0, "eval_wh": wh}
    out = {k: v / n_ok for k, v in sums.items()}
    out.update(n_images=n_ok, extraction_failures=n_fail, eval_wh=wh,
               via="proxynet_extractor")
    return out
