"""Random soccer bodies and a hard rasteriser, for the traffic generators.

Poses, shapes and cameras follow the measured package's synthetic ranges:
per-joint axis-angle noise scaled by joint (hips, knees, ankles,
shoulders, elbows and wrists their own) and by an articulation energy in
[0.4, 1.5), knees flexing one way, an upright orientation (π about x)
with tilt and sway noise composed with a uniform yaw, betas N(0, 1.5²).
Everything is drawn from one ``torch.Generator`` on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import pairs
from benchmark.reference import smpl

POSE_SCALE = np.full((23, 3), 0.12, np.float32)
POSE_SCALE[[0, 1]] = (0.55, 0.25, 0.25)
POSE_SCALE[[3, 4]] = (0.65, 0.10, 0.10)
POSE_SCALE[[6, 7]] = (0.30, 0.15, 0.15)
POSE_SCALE[[15, 16]] = (0.35, 0.45, 0.45)
POSE_SCALE[[17, 18]] = (0.25, 0.60, 0.30)
POSE_SCALE[[19, 20]] = (0.25, 0.25, 0.25)


def uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def normal(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def random_bodies(gen: torch.Generator, n: int, energy=(0.4, 1.5),
                  betas_scale: float = 1.5):
    """(body_rot (n, 23, 3, 3), orient_rot (n, 1, 3, 3), betas (n, 10))."""
    dev = gen.device
    noise = normal(gen, (n, 23, 3))
    en = uniform(gen, (n, 1, 1), *energy)
    tilt, sway = normal(gen, (n, 1)), normal(gen, (n, 2))
    yaw = uniform(gen, (n,), -math.pi, math.pi)
    betas = normal(gen, (n, 10)) * betas_scale
    aa = noise * torch.as_tensor(POSE_SCALE, device=dev)[None] * en
    aa[:, [3, 4], 0] = torch.abs(aa[:, [3, 4], 0])
    body = smpl.rodrigues(aa)
    upright = smpl.rodrigues(torch.cat(
        [torch.full((n, 1), math.pi, device=dev) + tilt * 0.25,
         sway * 0.15], -1))
    zero = torch.zeros_like(yaw)
    yaw_rm = smpl.rodrigues(torch.stack([zero, yaw, zero], -1))
    return body, (upright @ yaw_rm)[:, None], betas


def inside(tri: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """(P,) bool: pixel centres (x, y) inside triangles (P, 3, 2), edges
    included, either winding."""
    def cross(p0, p1):
        return ((p1[:, 0] - p0[:, 0]) * (y - p0[:, 1])
                - (p1[:, 1] - p0[:, 1]) * (x - p0[:, 0]))

    c0 = cross(tri[:, 0], tri[:, 1])
    c1 = cross(tri[:, 1], tri[:, 2])
    c2 = cross(tri[:, 2], tri[:, 0])
    return (((c0 >= 0) & (c1 >= 0) & (c2 >= 0))
            | ((c0 <= 0) & (c1 <= 0) & (c2 <= 0)))


def covered_pairs(tri: torch.Tensor, w: int, h: int):
    """(triangle index, x, y) of the pixels each triangle (N, 3, 2) covers
    in a w × h image."""
    wh = max(w, h)
    k, px, py = pairs.enumerate_pairs(pairs.face_boxes(tri, 0.0), wh)
    ok = inside(tri[k], px.float(), py.float()) & (px < w) & (py < h)
    return k[ok], px[ok], py[ok]


def silhouettes(verts2d: torch.Tensor, faces: torch.Tensor, wh: int):
    """(B, wh, wh) {0, 1} coverage of the front faces of each mesh."""
    b = verts2d.shape[0]
    tri = verts2d[:, faces]
    row, face = torch.nonzero(pairs.front_faces(tri), as_tuple=True)
    k, px, py = covered_pairs(tri[row, face], wh, wh)
    out = torch.zeros(b * wh * wh, device=verts2d.device)
    out[(row[k] * wh + py) * wh + px] = 1.0
    return out.reshape(b, wh, wh)
