"""Plain single-view render-and-compare fit, one trajectory per row.

The published optimisation (SPIN-style, Adam at lr 1e-3 for 100
iterations) over the global orientation, the body pose without hands and
feet, the weak-perspective camera and the betas, the rotation matrices
free 3×3 tensors. The loss is the homoscedastic multi-task loss at fixed
log-variances −log(w + 1e-6) of the weights {joints2D 1, silhouette 1e6}:

* joints2D: mean squared error of the keypoints normalised by
  ``2j/256 − 1`` (256 though they live in 512² pixels), the mean taken
  over the whole batch's ``rows × 17 × 2`` values;
* silhouette: ``−Σ p·log(t + 1e-6) + (1 − p)·log(1 − t + 1e-6)``.

An iterate is kept when both the mean 2-D joint error and the silhouette
score are at most the best so far; the kept parameters are those the
iterate was evaluated at. Rows are independent given the batch size, so
the reference follows any subset of a batch's rows; it records every
iterate's parameters and metrics, so that a fit's chosen iterate can be
judged against the same iterate here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import smpl
from benchmark.reference.silhouette import soft_silhouette

TRAINABLE = [j for j in range(smpl.NUM_BODY_JOINTS)
             if j not in smpl.FROZEN_BODY_JOINTS]


class Trajectory(NamedTuple):
    body_pose: torch.Tensor     # (T, B, 23, 3, 3) evaluated at iterate t
    orient: torch.Tensor        # (T, B, 1, 3, 3)
    betas: torch.Tensor         # (T, B, 10)
    cam_wp: torch.Tensor        # (T, B, 3)
    j2d_err: torch.Tensor       # (T, B) mean 2-D joint error, px
    bce: torch.Tensor           # (T, B) silhouette score
    iou: torch.Tensor           # (T, B)
    loss: torch.Tensor          # (T, B) the row's share of the loss
    best_iter: torch.Tensor     # (B,) 1-based


def splice(sub: torch.Tensor, init: torch.Tensor) -> torch.Tensor:
    return torch.cat([sub[:, :6], init[:, 6:8], sub[:, 6:19],
                      init[:, 21:23]], 1)


def iou(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    p = torch.round(pred) > 0.5
    t = torch.round(target) > 0.5
    tp = (p & t).sum((-2, -1)).float()
    return tp / (tp + (p & ~t).sum((-2, -1)).float()
                 + (~p & t).sum((-2, -1)).float())


LV_J = float(np.float32(-np.log(1.0 + 1e-6)))
LV_S = float(np.float32(-np.log(1e6 + 1e-6)))


def _terms(model, pose, orient, betas, cam, target_sil, target_j2d,
           batch_rows: int, sigma: float, wh: int):
    """Per row: (projected keypoints, soft silhouette, BCE, the row's
    share of the loss without the constant log-variances)."""
    verts, joints = smpl.forward(model, betas, pose, orient)
    j2d = smpl.keypoints(joints, cam, wh)
    sil = soft_silhouette(smpl.project(verts, smpl.translation(cam, wh), wh),
                          model.faces, wh, sigma)
    bce = -torch.sum(sil * torch.log(target_sil + 1e-6)
                     + (1.0 - sil) * torch.log(1.0 - target_sil + 1e-6),
                     (-2, -1))
    se = ((2.0 * j2d / 256.0 - 1.0) - (2.0 * target_j2d / 256.0 - 1.0)) ** 2
    loss = (se.sum((-2, -1)) / (batch_rows * 17 * 2) * math.exp(-LV_J)
            + bce * math.exp(-LV_S))
    return j2d, sil, bce, loss


@torch.no_grad()
def evaluate(model: smpl.Model, rotmats, betas, cam_wp, target_sil,
             target_j2d, batch_rows: int, sigma: float, wh: int) -> dict:
    """The metrics and the loss share of each row at given parameters
    (rotmats (B, 24, 3, 3): orientation, then the body)."""
    j2d, sil, bce, loss = _terms(model, rotmats[:, 1:], rotmats[:, :1],
                                 betas, cam_wp, target_sil, target_j2d,
                                 batch_rows, sigma, wh)
    return {"j2d_err": torch.linalg.vector_norm(
        j2d - target_j2d, dim=-1).mean(-1), "bce": bce,
        "iou": iou(sil, target_sil), "loss": loss}


def fit(model: smpl.Model, body_pose, orient, betas, cam_wp, target_sil,
        target_j2d, batch_rows: int, iters: int, lr: float, sigma: float,
        wh: int) -> Trajectory:
    """Fit the given rows from their initial parameters; ``batch_rows`` is
    the size of the batch they belong to (the joints term's mean)."""
    init_pose = body_pose
    params = [orient.clone(), body_pose[:, TRAINABLE].clone(),
              cam_wp.clone(), betas.clone()]
    for p in params:
        p.requires_grad_(True)
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    hist = {k: [] for k in Trajectory._fields[:8]}
    for step in range(1, iters + 1):
        orient_p, sub, cam, bet = params
        pose = splice(sub, init_pose)
        j2d, sil, bce, loss = _terms(model, pose, orient_p, bet, cam,
                                     target_sil, target_j2d, batch_rows,
                                     sigma, wh)
        total = torch.sum(loss) + LV_J + LV_S
        grads = torch.autograd.grad(total, params)
        with torch.no_grad():
            hist["body_pose"].append(pose.detach())
            hist["orient"].append(orient_p.detach().clone())
            hist["betas"].append(bet.detach().clone())
            hist["cam_wp"].append(cam.detach().clone())
            hist["j2d_err"].append(torch.linalg.vector_norm(
                j2d - target_j2d, dim=-1).mean(-1))
            hist["bce"].append(bce.detach())
            hist["iou"].append(iou(sil.detach(), target_sil))
            hist["loss"].append(loss.detach())
            b1, b2 = 1.0 - 0.9 ** step, 1.0 - 0.999 ** step
            for p, g, mi, vi in zip(params, grads, m, v):
                mi.mul_(0.9).add_(g, alpha=0.1)
                vi.mul_(0.999).addcmul_(g, g, value=0.001)
                denom = (vi.sqrt() / math.sqrt(b2)).add_(1e-8)
                p.addcdiv_(mi, denom, value=-lr / b1)
    h = {k: torch.stack(x) for k, x in hist.items()}
    return Trajectory(best_iter=best_iterate(h["j2d_err"], h["bce"]), **h)


def best_iterate(j2d_err: torch.Tensor, bce: torch.Tensor) -> torch.Tensor:
    """(B,) 1-based: the last iterate at which every metric was at most
    its best so far."""
    best0 = torch.full_like(j2d_err[0], float("inf"))
    best1 = torch.full_like(bce[0], float("inf"))
    it = torch.zeros_like(j2d_err[0], dtype=torch.int64)
    for t in range(j2d_err.shape[0]):
        ok = (j2d_err[t] <= best0) & (bce[t] <= best1)
        best0 = torch.where(ok, j2d_err[t], best0)
        best1 = torch.where(ok, bce[t], best1)
        it = torch.where(ok, torch.full_like(it, t + 1), it)
    return it
