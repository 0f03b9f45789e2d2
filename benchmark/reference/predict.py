"""Plain crop → SMPL prediction: the proxy, the regressor, SMPL.

The 18-channel proxy is the silhouette resized nearest to 256² and 17
Gaussian keypoint heatmaps (σ 4 px, a 4σ window sampled by
``linspace(-2σ, 2σ, 4σ)``, centres truncated toward zero after scaling by
256/512, the last row and column never written, a joint dropped unless
every coordinate lies strictly inside (-2σ, 255 + 2σ)). The regressor's 6D
pose becomes rotation matrices with columns (b1, b2, b1 × b2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import nets, smpl

REGRESSOR_WH = 256
HEATMAP_STD = 4


def resize_nearest(x: torch.Tensor, out_wh: int) -> torch.Tensor:
    in_h, in_w = x.shape[-2], x.shape[-1]
    if in_h % out_wh == 0 and in_w % out_wh == 0:
        return x[..., ::in_h // out_wh, ::in_w // out_wh]
    dst = torch.arange(out_wh, dtype=torch.float32, device=x.device)
    ys = (dst * (in_h / out_wh)).to(torch.long)
    xs = (dst * (in_w / out_wh)).to(torch.long)
    return x[..., ys[:, None], xs[None, :]]


def heatmaps(joints: torch.Tensor, wh: int) -> torch.Tensor:
    """(B, N, 2) pixel joints → (B, N, wh, wh)."""
    std = HEATMAP_STD
    size, n_win = 2 * std, 4 * std
    step = (2.0 * size) / (n_win - 1)
    c = torch.trunc(joints).to(torch.int32)
    px = torch.arange(wh, dtype=torch.int32, device=joints.device)

    def profile(centre):
        g = px[None, :] - (centre.reshape(-1)[:, None] - size)
        ok = (g >= 0) & (g < n_win) & (px[None, :] <= wh - 2)
        u = -size + g.to(torch.float32) * step
        return torch.where(ok, torch.exp(-(u * u) / (2.0 * std * std)), 0.0)

    px_, py_ = profile(c[..., 0]), profile(c[..., 1])
    ok = torch.all((c > -size) & (c < wh - 1 + size), -1).reshape(-1)
    hm = py_[:, :, None] * px_[:, None, :] * ok.to(torch.float32)[:, None,
                                                                  None]
    return hm.reshape(joints.shape[:-1] + (wh, wh))


def proxy(silhouette: torch.Tensor, joints2d: torch.Tensor, in_wh: int):
    """(B, 18, 256, 256): [silhouette, 17 heatmaps]."""
    j = torch.trunc(joints2d[..., :2] * (REGRESSOR_WH / float(in_wh)))
    return torch.cat([resize_nearest(silhouette, REGRESSOR_WH)[:, None],
                      heatmaps(j, REGRESSOR_WH)], 1)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    m = x.reshape(x.shape[:-1] + (3, 2))
    a1, a2 = m[..., 0], m[..., 1]
    b1 = a1 / torch.clamp(torch.linalg.vector_norm(a1, dim=-1,
                                                   keepdim=True), min=1e-12)
    a2p = a2 - torch.sum(b1 * a2, -1, keepdim=True) * b1
    b2 = a2p / torch.clamp(torch.linalg.vector_norm(a2p, dim=-1,
                                                    keepdim=True), min=1e-12)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], -1)


def initial_params(device) -> torch.Tensor:
    """IEF's start: camera (0.9, 0, 0), the identity 6D pose, zero shape."""
    pose = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0, 0.0],
                        device=device).repeat(smpl.NUM_JOINTS)
    return torch.cat([torch.tensor([0.9, 0.0, 0.0], device=device), pose,
                      torch.zeros(smpl.NUM_BETAS, device=device)])


class Prediction(NamedTuple):
    rotmats: torch.Tensor      # (B, 24, 3, 3)
    betas: torch.Tensor        # (B, 10)
    cam_wp: torch.Tensor       # (B, 3)
    vertices: torch.Tensor     # (B, 6890, 3)
    joints2d: torch.Tensor     # (B, 17, 2) px


@torch.no_grad()
def predict(w: dict, model: smpl.Model, silhouette, joints2d,
            in_wh: int) -> Prediction:
    cam, pose6d, betas = nets.regressor(
        w, proxy(silhouette, joints2d, in_wh), initial_params(betas_dev(w)))
    rot = rot6d_to_rotmat(pose6d.reshape(-1, smpl.NUM_JOINTS, 6))
    verts, joints = smpl.forward(model, betas, rot[:, 1:], rot[:, :1])
    return Prediction(rot, betas, cam, verts,
                      smpl.keypoints(joints, cam, in_wh))


def betas_dev(w: dict):
    return next(iter(w.values())).device
