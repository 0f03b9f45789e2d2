"""Plain broadcast-frame pipeline: detect, crop, proxy, predict.

One frame batch (F, H, W, 3) in [0, 1] goes through

1. the centre-point detector; a cell is a peak where its sigmoid score
   equals the 3×3 maximum around it, the K best cells (a stable
   descending sort: ties to the lower cell index) give boxes from their
   size (× stride 4) and offset (clipped to [−1, 2]), and greedy box NMS
   at IoU 0.7 (the first of equal scores wins) zeroes the scores of the
   boxes it suppresses;
2. each box grown by the border, squared on its longer side (≥ 8 px) and
   cut out by ROI align (one bilinear sample per output pixel at
   half-pixel centres, clamped to the frame's edge);
3. ProxyNet on the crops: the keypoint heatmaps' argmax cell refined by a
   parabola through the log-sigmoid (offset clipped to ±0.5), the
   silhouette thresholded at logit 0;
4. :func:`benchmark.reference.predict.predict` on each crop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.nn import functional as F

from benchmark.reference import nets, predict, smpl

STRIDE = 4
NMS_IOU = 0.7


class FrameResult(NamedTuple):
    boxes: torch.Tensor        # (F, K, 4) square crop boxes
    scores: torch.Tensor       # (F, K)
    joints2d: torch.Tensor     # (F, K, 17, 2) crop px
    vertices: torch.Tensor     # (F, K, 6890, 3)
    rotmats: torch.Tensor      # (F, K, 24, 3, 3)
    betas: torch.Tensor        # (F, K, 10)
    cam_wp: torch.Tensor       # (F, K, 3)


def box_iou(a, b):
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]))[..., :, None]
    area_b = ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]))[..., None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-9)


def nms_keep(boxes, scores, thresh: float) -> torch.Tensor:
    """(S, N) bool: the boxes greedy NMS keeps, set by set."""
    s, n = scores.shape
    iou = box_iou(boxes, boxes)
    rows = torch.arange(s, device=boxes.device)
    alive = torch.ones((s, n), dtype=torch.bool, device=boxes.device)
    kept = torch.zeros_like(alive)
    for _ in range(n):
        masked = torch.where(alive, scores, float("-inf"))
        best = torch.argmax(masked, -1)
        ok = masked[rows, best] > float("-inf")
        kept[rows[ok], best[ok]] = True
        alive = alive & ~(iou[rows, best] > thresh) & ok[:, None]
        alive[rows, best] = False
    return kept


def detect(w: dict, frames: torch.Tensor, top_k: int):
    center, size, offset = nets.detector(w, frames.permute(0, 3, 1, 2))
    b, h, wd, _ = center.shape
    heat = torch.sigmoid(center[..., 0])
    pooled = F.max_pool2d(heat[:, None], 3, stride=1, padding=1)[:, 0]
    peaks = torch.where(heat >= pooled, heat, 0.0).reshape(b, h * wd)
    scores, idx = torch.sort(peaks, dim=1, descending=True, stable=True)
    scores, idx = scores[:, :top_k], idx[:, :top_k]
    py = torch.div(idx, wd, rounding_mode="floor").to(torch.float32)
    px = (idx % wd).to(torch.float32)

    def take(t):
        return torch.gather(t.reshape(b, h * wd, t.shape[-1]), 1,
                            idx[..., None].expand(-1, -1, t.shape[-1]))

    bwh = take(size) * STRIDE
    off = torch.clamp(take(offset), -1.0, 2.0)
    cx = (px + 0.5 + off[..., 0]) * STRIDE
    cy = (py + 0.5 + off[..., 1]) * STRIDE
    boxes = torch.stack([cx - bwh[..., 0] / 2, cy - bwh[..., 1] / 2,
                         cx + bwh[..., 0] / 2, cy + bwh[..., 1] / 2], -1)
    scores = torch.where(nms_keep(boxes, scores, NMS_IOU), scores, 0.0)
    return boxes, scores


def square_boxes(boxes, border: float):
    cx = (boxes[..., 0] + boxes[..., 2]) / 2
    cy = (boxes[..., 1] + boxes[..., 3]) / 2
    side = torch.clamp(torch.maximum(boxes[..., 2] - boxes[..., 0],
                                     boxes[..., 3] - boxes[..., 1])
                       + 2 * border, min=8.0)
    return torch.stack([cx - side / 2, cy - side / 2, cx + side / 2,
                        cy + side / 2], -1)


def roi_align(frames, boxes, out: int):
    """(F, N, out, out, C): one bilinear sample per output pixel."""
    f, h, w, c = frames.shape
    x1, y1, x2, y2 = (boxes - 0.5).unbind(-1)
    cell = (torch.arange(out, device=frames.device) + 0.5) / out
    ys = y1[..., None] + cell * torch.clamp(y2 - y1, min=1e-6)[..., None]
    xs = x1[..., None] + cell * torch.clamp(x2 - x1, min=1e-6)[..., None]
    yy = ys[..., :, None].expand(-1, -1, out, out)
    xx = xs[..., None, :].expand(-1, -1, out, out)
    y0 = torch.clamp(torch.floor(yy), 0, h - 1)
    x0 = torch.clamp(torch.floor(xx), 0, w - 1)
    y1i, x1i = torch.clamp(y0 + 1, 0, h - 1), torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(yy - y0, 0.0, 1.0)[..., None]
    wx = torch.clamp(xx - x0, 0.0, 1.0)[..., None]
    flat = frames.reshape(f * h * w, c)
    base = (torch.arange(f, device=frames.device) * (h * w)).reshape(
        f, 1, 1, 1)

    def at(yi, xi):
        return flat[base + yi.to(torch.long) * w + xi.to(torch.long)]

    top = at(y0, x0) * (1 - wx) + at(y0, x1i) * wx
    bot = at(y1i, x0) * (1 - wx) + at(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


def decode_keypoints(kp_logits, stride: int):
    b, h, w, k = kp_logits.shape
    hm = kp_logits.reshape(b, h * w, k)
    idx = torch.argmax(hm, dim=1)
    py, px = torch.div(idx, w, rounding_mode="floor"), idx % w

    def logp(dy, dx):
        yy = torch.clamp(py + dy, 0, h - 1)
        xx = torch.clamp(px + dx, 0, w - 1)
        return -F.softplus(-torch.gather(hm, 1, (yy * w + xx)[:, None, :]
                                         )[:, 0, :])

    def vertex(lo, c, hi):
        denom = lo - 2.0 * c + hi
        flat = torch.abs(denom) < 1e-6
        off = 0.5 * (lo - hi) / torch.where(flat, 1.0, denom)
        return torch.clamp(torch.where(flat, 0.0, off), -0.5, 0.5)

    c = logp(0, 0)
    dx = vertex(logp(0, -1), c, logp(0, 1))
    dy = vertex(logp(-1, 0), c, logp(1, 0))
    x = torch.clamp((px.float() + dx + 0.5) * stride, 0.0, w * stride - 1.0)
    y = torch.clamp((py.float() + dy + 0.5) * stride, 0.0, h * stride - 1.0)
    return torch.stack([x, y], -1)


@torch.no_grad()
def run(det_w: dict, pn_w: dict, reg_w: dict, model: smpl.Model,
        frames: torch.Tensor, top_k: int, crop: int,
        border: float) -> FrameResult:
    f = frames.shape[0]
    boxes, scores = detect(det_w, frames, top_k)
    sq = square_boxes(boxes, border)
    crops = roi_align(frames, sq, crop).reshape(f * top_k, crop, crop, 3)
    kp_logits, mask_logits = nets.proxynet(pn_w, crops.permute(0, 3, 1, 2))
    sil = (mask_logits > 0.0).to(torch.float32)
    kps = decode_keypoints(kp_logits, crop // kp_logits.shape[1])
    p = predict.predict(reg_w, model, sil, kps, crop)

    def per(x):
        return x.reshape((f, top_k) + tuple(x.shape[1:]))

    return FrameResult(sq, scores, per(p.joints2d), per(p.vertices),
                       per(p.rotmats), per(p.betas), per(p.cam_wp))


def count_flops(det_w, pn_w, reg_w, frame_hw, top_k: int, crop: int
                ) -> float:
    """Operations of one frame: the detector, ProxyNet on the K crops, the
    regressor on their proxies (convolutions and dense layers, from the
    layer shapes) and SMPL's forward on K bodies."""
    h, w = frame_hw
    ops = nets.count_flops(nets.detector, det_w, (1, 3, h, w))
    ops += nets.count_flops(nets.proxynet, pn_w, (top_k, 3, crop, crop))
    ops += regressor_flops(reg_w, top_k)
    return ops + top_k * smpl_forward_flops()


def regressor_flops(reg_w: dict, rows: int) -> float:
    counter = nets.OpCounter()
    meta = nets.on_meta(reg_w)
    with counter.active():
        nets.regressor(meta, torch.empty((rows, 18, predict.REGRESSOR_WH,
                                          predict.REGRESSOR_WH),
                                         device="meta"),
                       torch.empty((157,), device="meta"))
    return counter.flops


def smpl_forward_flops() -> float:
    """Operations of one body's SMPL forward, as dense contractions: shape
    and pose blendshapes, the joint regressor, the blend of the 24
    transforms, their application, the 45 regressed joints."""
    v3 = smpl.NUM_VERTS * 3
    return 2.0 * (v3 * smpl.NUM_BETAS + 9 * smpl.NUM_BODY_JOINTS * v3
                  + smpl.NUM_JOINTS * v3 + smpl.NUM_VERTS * 24 * 12
                  + smpl.NUM_VERTS * 12 + (9 + 19 + 17) * v3)
