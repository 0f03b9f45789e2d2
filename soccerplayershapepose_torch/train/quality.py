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

and of the detector (:func:`evaluate_detector`) on held-out synthetic
frames: AP at IoU 0.5 (all-point interpolated), recall and precision at
the operating point (score ≥ 0.7), the mean IoU of matched boxes and the
best-F1 point of the precision-recall curve, with COCO-style ignore
handling of heavily occluded players. The matching runs on the host, in
numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch

from soccerplayershapepose_torch.models.detector import (
    PlayerDetector, apply_flip_tta, decode_detections)
from soccerplayershapepose_torch.pipeline.extract import ProxyExtractor
from soccerplayershapepose_torch.pipeline.predict import on_device
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.train.straps import crop_images_u8
from soccerplayershapepose_torch.train.synth import (
    CropDraws, FrameDraws, render_crop_batch, render_frame_batch,
    sample_crop_draws, sample_frame_draws)
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, default_device)

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


def _box_iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, M) IoU between two corner-format box sets."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-9)


@torch.no_grad()
def evaluate_detector(model: PlayerDetector, assets: SMPLAssets,
                      n_batches: int = 8, batch: int = 4,
                      hw: tuple = (256, 448), n_players: int = 8,
                      seed: int = 0, iou_thresh: float = 0.5,
                      score_thresh: float = 0.7, flip_tta: bool = False,
                      ignore_below_fill: float = 0.12,
                      draws: Optional[Iterable[FrameDraws]] = None,
                      device: DeviceLike = None) -> dict:
    """AP at ``iou_thresh`` plus precision and recall at ``score_thresh``
    on held-out synthetic frames, on ``device`` (None: the CUDA card).

    Batch ``bi`` draws its geometry from a CPU generator and its
    appearance from one on the device, both seeded ``EVAL_SEED_BASE +
    500,000 + seed · 100,000 + bi``, unless ``draws`` (one per batch) are
    given. Every detection scoring above 1e-4 is matched greedily in
    descending score order to the unmatched ground-truth box of largest
    IoU. ``ignore_below_fill``: ground-truth boxes whose visible fill is
    below it are left out of the ground truth, and a detection that
    matches none of the rest but one of them (IoU ≥ ``iou_thresh``) is
    dropped from scoring rather than counted false (COCO-style ignore; 0
    counts every box).
    """
    dev = default_device(device)
    model = model.to(dev).eval()
    assets = on_device(assets, dev)
    if draws is None:
        seeds = [EVAL_SEED_BASE + 500_000 + seed * 100_000 + bi
                 for bi in range(n_batches)]
        draws = (sample_frame_draws(
            torch.Generator().manual_seed(k), batch, n_players, hw,
            image_gen=torch.Generator(device=dev).manual_seed(k))
            for k in seeds)

    records = []      # (score, is_tp)
    n_gt = n_ignored_gt = 0
    matched_ious = []
    tp_at_op = fp_at_op = 0
    for d in draws:
        data = render_frame_batch(assets, d, hw)
        images = data["image"].permute(0, 3, 1, 2)
        out = apply_flip_tta(model, images) if flip_tta else model(images)
        dets = decode_detections(out)
        boxes = dets.boxes.cpu().numpy()
        scores = dets.scores.cpu().numpy()
        gt_boxes = data["boxes"].cpu().numpy()
        gt_mask = data["mask"].cpu().numpy() > 0.5
        fill = data["visible_fill"].cpu().numpy()
        for i in range(len(boxes)):
            visible = gt_mask[i] & (fill[i] >= ignore_below_fill)
            ignored = gt_mask[i] & ~visible
            gt = gt_boxes[i][visible]
            gt_ign = gt_boxes[i][ignored]
            n_gt += len(gt)
            n_ignored_gt += len(gt_ign)
            iou = _box_iou_matrix(boxes[i], gt)
            iou_ign = _box_iou_matrix(boxes[i], gt_ign)
            taken = np.zeros(len(gt), bool)
            for k in np.argsort(-scores[i]):         # descending score
                if scores[i][k] <= 1e-4:
                    continue
                tp = False
                if len(gt):
                    j = int(np.argmax(np.where(taken, -1.0, iou[k])))
                    if not taken[j] and iou[k, j] >= iou_thresh:
                        taken[j] = True
                        tp = True
                        matched_ious.append(float(iou[k, j]))
                if not tp and len(gt_ign) \
                        and iou_ign[k].max() >= iou_thresh:
                    continue          # matches an ignored (occluded) box
                records.append((float(scores[i][k]), tp))
                if scores[i][k] >= score_thresh:
                    tp_at_op += int(tp)
                    fp_at_op += int(not tp)

    records.sort(key=lambda r: -r[0])
    tps = np.cumsum([r[1] for r in records]) if records else np.array([0])
    fps = np.cumsum([not r[1] for r in records]) if records else np.array([0])
    recall = tps / max(n_gt, 1)
    precision = tps / np.maximum(tps + fps, 1)
    ap = prev_r = 0.0                 # all-point interpolated AP
    for r, p in zip(recall, np.maximum.accumulate(precision[::-1])[::-1]):
        ap += (r - prev_r) * p
        prev_r = r
    # The best-F1 point: the threshold to deploy if the net's confidence
    # calibration differs from the reference's 0.7.
    f1 = 2 * precision * recall / np.maximum(precision + recall, 1e-9)
    bi = int(np.argmax(f1)) if records else 0
    return {
        "eval_hw": list(hw),
        "n_gt_boxes": n_gt,
        "n_ignored_gt_boxes": n_ignored_gt,
        "ignore_below_fill": ignore_below_fill,
        f"ap@{iou_thresh}": float(ap),
        f"recall@score{score_thresh}": tp_at_op / max(n_gt, 1),
        f"precision@score{score_thresh}":
            tp_at_op / max(tp_at_op + fp_at_op, 1),
        "mean_matched_iou": (float(np.mean(matched_ious)) if matched_ious
                             else float("nan")),
        "best_f1": float(f1[bi]) if records else 0.0,
        "best_f1_score_thresh": float(records[bi][0]) if records else 0.0,
        "best_f1_precision": float(precision[bi]) if records else 0.0,
        "best_f1_recall": float(recall[bi]) if records else 0.0,
    }
