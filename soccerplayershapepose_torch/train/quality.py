"""Held-out quality of ProxyNet through the deployment extraction path.

Counterpart of ``evaluate_proxynet`` and its helpers in
``soccerplayershapepose_tpu/train/quality.py``: synthetic RGB crops from
seeds far from any training stream go through the extractor
(``pipeline/extract.py:ProxyExtractor``, instance gating included), and
its output is held against the crops' labels:

* keypoints: median and mean pixel error, PCK@0.05 and PCK@0.10 of the
  ground-truth silhouette's bbox extent, over the visible joints;
* score reliability: rank-AUC of the keypoint scores separating good
  localisations (error ≤ 0.1 · extent) from bad ones, and the mean score
  of each;
* silhouette: mean mask IoU;
* IUV: part accuracy on ground-truth foreground cells (the decoded IUV
  sampled at cell centres), and the UV L1 where the part is right.

``evaluate_detector`` is not ported yet.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from soccerplayershapepose_torch.pipeline.extract import ProxyExtractor
from soccerplayershapepose_torch.pipeline.predict import on_device
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.train.straps import crop_images_u8
from soccerplayershapepose_torch.train.synth import (
    CropDraws, render_crop_batch, sample_crop_draws)

# Held-out seed base: training uses sequential small seeds; evaluation seeds
# live far away so the streams never overlap.
EVAL_SEED_BASE = 10_000_000


def _bbox_extent(sil: np.ndarray) -> float:
    ys, xs = np.nonzero(sil > 0.5)
    if len(ys) == 0:
        return 1.0
    return float(max(ys.max() - ys.min(), xs.max() - xs.min(), 1))


def _rank_auc(scores_pos: np.ndarray, scores_neg: np.ndarray) -> float:
    """P(score_pos > score_neg) for a random (pos, neg) pair, ties 0.5."""
    if len(scores_pos) == 0 or len(scores_neg) == 0:
        return float("nan")
    order = np.concatenate([scores_pos, scores_neg])
    ranks = np.empty(len(order))
    sort = np.argsort(order, kind="stable")
    sorted_vals = order[sort]
    ranks[sort] = np.arange(1, len(order) + 1)
    for v in np.unique(sorted_vals):          # average ranks of ties
        m = order == v
        ranks[m] = ranks[m].mean()
    r_pos = ranks[:len(scores_pos)].sum()
    n_p, n_n = len(scores_pos), len(scores_neg)
    return float((r_pos - n_p * (n_p + 1) / 2) / (n_p * n_n))


@torch.no_grad()
def evaluate_proxynet(extractor: ProxyExtractor, assets: SMPLAssets,
                      n_batches: int = 8, batch: int = 8, wh: int = 256,
                      seed: int = 0, occluders: bool = True,
                      domain_rand: bool = True,
                      draws: Optional[Iterable[CropDraws]] = None) -> dict:
    """Run the extraction path on held-out synthetic crops at ``wh``² on
    the extractor's device. Batch ``bi`` draws its geometry from a CPU
    generator and its appearance from one on the device, both seeded
    ``EVAL_SEED_BASE + seed · 100,000 + bi``, unless ``draws`` (one per
    batch) are given. Returns the metrics of the module docstring."""
    dev = extractor.device
    assets = on_device(assets, dev)
    if draws is None:
        seeds = [EVAL_SEED_BASE + seed * 100_000 + bi
                 for bi in range(n_batches)]
        draws = (sample_crop_draws(
            torch.Generator().manual_seed(k), batch, image_wh=wh,
            domain_rand=domain_rand, occluders=occluders,
            image_gen=torch.Generator(device=dev).manual_seed(k))
            for k in seeds)
    kp_errs, kp_scores, kp_good = [], [], []
    pck05 = pck10 = n_vis = 0
    ious = []
    part_correct = part_total = 0
    uv_l1 = []
    failures = n_images = 0
    for d in draws:
        data = render_crop_batch(assets, d, wh, with_image=True)
        results = extractor(crop_images_u8(data["image"]))
        gt_j2d = data["joints2d"].cpu().numpy()
        gt_vis = data["kp_visible"].cpu().numpy() > 0.5
        gt_sil = data["silhouette"].cpu().numpy()
        gt_part = data["part"].cpu().numpy()
        gt_uv = data["uv"].cpu().numpy()
        for i, (kp, sil, iuv) in enumerate(results):
            n_images += 1
            if kp is None:
                failures += 1
                continue
            ext = _bbox_extent(gt_sil[i])
            err = np.linalg.norm(kp[:, :2] - gt_j2d[i], axis=-1)
            good = err <= 0.1 * ext
            vis = gt_vis[i]
            kp_errs.append(err[vis])
            kp_scores.append(kp[:, 2])
            kp_good.append(good)
            pck05 += int((err[vis] <= 0.05 * ext).sum())
            pck10 += int((err[vis] <= 0.10 * ext).sum())
            n_vis += int(vis.sum())

            inter = float(np.sum((sil > 0.5) & (gt_sil[i] > 0.5)))
            union = float(np.sum((sil > 0.5) | (gt_sil[i] > 0.5)))
            ious.append(inter / union if union else 1.0)

            if iuv is not None:
                s = wh // gt_part.shape[1]
                pred_part = iuv[s // 2::s, s // 2::s, 0].astype(np.int32)
                fg = gt_part[i] > 0
                part_correct += int((pred_part[fg] == gt_part[i][fg]).sum())
                part_total += int(fg.sum())
                match = fg & (pred_part == gt_part[i])
                if match.any():
                    pred_uv = iuv[s // 2::s, s // 2::s, 1:] / 255.0
                    uv_l1.append(float(np.abs(pred_uv[match]
                                              - gt_uv[i][match]).mean()))

    errs = np.concatenate(kp_errs) if kp_errs else np.array([np.nan])
    scores = np.concatenate(kp_scores) if kp_scores else np.array([])
    goods = np.concatenate(kp_good) if kp_good else np.array([], bool)
    auc = (_rank_auc(scores[goods], scores[~goods]) if len(scores)
           else float("nan"))
    return {
        "eval_wh": wh,
        "n_images": n_images,
        "extraction_failures": failures,
        "occluders": bool(occluders),
        "domain_rand": bool(domain_rand),
        "kp_median_px_err": float(np.median(errs)),
        "kp_mean_px_err": float(np.mean(errs)),
        "kp_pck@0.05bbox": pck05 / max(n_vis, 1),
        "kp_pck@0.10bbox": pck10 / max(n_vis, 1),
        "kp_score_rank_auc": auc,
        "kp_score_mean_good": (float(scores[goods].mean()) if goods.any()
                               else float("nan")),
        "kp_score_mean_bad": (float(scores[~goods].mean()) if (~goods).any()
                              else float("nan")),
        "mask_mean_iou": float(np.mean(ious)) if ious else float("nan"),
        "iuv_part_acc": part_correct / part_total if part_total else None,
        "iuv_uv_l1": float(np.mean(uv_l1)) if uv_l1 else None,
    }
