"""Plain SMPL: the deterministic stand-in model and its forward pass.

A frozen copy of the stand-in that the measured package synthesises (a
closed sphere mesh at SMPL's published sizes: 6890 vertices, 13776 faces,
24 joints, 10 betas, 207 pose blendshapes, drawn from
``np.random.RandomState(0)`` in a fixed order), and of the batched forward
pass: shape and pose blendshapes, the kinematic chain, linear blend
skinning and the joint regressors (90 output joints). Plain PyTorch; every
contraction goes through :mod:`benchmark.reference.precision`, so the
control can run it in TF32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference.precision import einsum, matmul

NUM_VERTS = 6890
NUM_FACES = 13776
NUM_BETAS = 10
NUM_JOINTS = 24
NUM_BODY_JOINTS = 23
FOCAL_LENGTH = 5000.0
PARENTS = (-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8,
           9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21)
EXTRA_JOINT_VERTEX_IDS = (
    332, 6260, 2800, 4071, 583, 3216, 3226, 3387, 6617, 6624, 6787,
    2746, 2319, 2445, 2556, 2673, 6191, 5782, 5905, 6016, 6133)
# 90-joint superset → the 17 KP-RCNN keypoints.
SMPL_TO_KPRCNN = (24, 26, 25, 28, 27, 16, 17, 18, 19, 20, 21,
                  1, 2, 4, 5, 7, 8)
# Body joints that a fit leaves at their initial rotation (hands, feet).
FROZEN_BODY_JOINTS = (6, 7, 21, 22)

_JOINT_POSITIONS = np.array([
    [0.00, 0.00, 0.0], [0.09, -0.07, 0.0], [-0.09, -0.07, 0.0],
    [0.00, 0.12, 0.0], [0.10, -0.45, 0.0], [-0.10, -0.45, 0.0],
    [0.00, 0.25, 0.0], [0.10, -0.85, 0.0], [-0.10, -0.85, 0.0],
    [0.00, 0.32, 0.0], [0.12, -0.92, 0.10], [-0.12, -0.92, 0.10],
    [0.00, 0.45, 0.0], [0.08, 0.40, 0.0], [-0.08, 0.40, 0.0],
    [0.00, 0.58, 0.0], [0.18, 0.42, 0.0], [-0.18, 0.42, 0.0],
    [0.45, 0.42, 0.0], [-0.45, 0.42, 0.0], [0.70, 0.42, 0.0],
    [-0.70, 0.42, 0.0], [0.78, 0.42, 0.0], [-0.78, 0.42, 0.0],
], dtype=np.float64)


def _sphere_mesh(n_rings: int = 82, n_cols: int = 84):
    v = np.zeros((n_rings * n_cols + 2, 3), dtype=np.float64)
    v[0] = (0.0, 1.0, 0.0)
    v[-1] = (0.0, -1.0, 0.0)
    r = np.arange(n_rings)[:, None]
    c = np.arange(n_cols)[None, :]
    phi = np.pi * (r + 1) / (n_rings + 1)
    theta = 2 * np.pi * c / n_cols
    v[1:-1] = np.stack([np.sin(phi) * np.cos(theta),
                        np.broadcast_to(np.cos(phi), (n_rings, n_cols)),
                        np.sin(phi) * np.sin(theta)], -1).reshape(-1, 3)

    def ring(rr, cc):
        return 1 + rr * n_cols + (cc % n_cols)

    faces = [(0, ring(0, cc + 1), ring(0, cc)) for cc in range(n_cols)]
    for rr in range(n_rings - 1):
        for cc in range(n_cols):
            a, b = ring(rr, cc), ring(rr, cc + 1)
            d, e = ring(rr + 1, cc), ring(rr + 1, cc + 1)
            faces += [(a, b, e), (a, e, d)]
    last = n_rings * n_cols + 1
    faces += [(last, ring(n_rings - 1, cc), ring(n_rings - 1, cc + 1))
              for cc in range(n_cols)]
    return v, np.asarray(faces, dtype=np.int64)


def synthesize(seed: int = 0) -> dict:
    """The stand-in model as numpy arrays."""
    rng = np.random.RandomState(seed)
    v_sphere, faces = _sphere_mesh()
    if v_sphere.shape[0] != NUM_VERTS or faces.shape[0] != NUM_FACES:
        raise AssertionError("the sphere mesh lacks SMPL's sizes")
    v_template = v_sphere * np.array([0.45, 0.85, 0.22]) \
        + np.array([0.0, -0.15, 0.0])
    d2 = ((v_template[:, None, :] - _JOINT_POSITIONS[None]) ** 2).sum(-1)
    logits = -d2 / 0.02
    logits -= logits.max(axis=1, keepdims=True)
    w = np.exp(logits)
    lbs_weights = w / w.sum(axis=1, keepdims=True)
    j_regressor = np.zeros((NUM_JOINTS, NUM_VERTS))
    for j in range(NUM_JOINTS):
        nearest = np.argsort(d2[:, j])[:32]
        wj = np.exp(-d2[nearest, j] / 0.01)
        j_regressor[j, nearest] = wj / wj.sum()

    def sparse_regressor(n_joints: int, spread: float = 0.02):
        reg = np.zeros((n_joints, NUM_VERTS))
        for j, a in enumerate(rng.randint(0, NUM_VERTS, size=n_joints)):
            d = ((v_template - v_template[a]) ** 2).sum(-1)
            nearest = np.argsort(d)[:24]
            wj = np.exp(-d[nearest] / spread)
            reg[j, nearest] = wj / wj.sum()
        return reg

    shapedirs = rng.randn(NUM_VERTS, 3, NUM_BETAS) * 0.01
    posedirs = rng.randn(9 * NUM_BODY_JOINTS, NUM_VERTS * 3) * 0.001
    extra = sparse_regressor(9)
    cocoplus = sparse_regressor(19)
    h36m = sparse_regressor(17)
    return {"v_template": v_template, "shapedirs": shapedirs,
            "posedirs": posedirs, "j_regressor": j_regressor,
            "lbs_weights": lbs_weights, "faces": faces,
            "j_regressor_extra": extra, "j_regressor_cocoplus": cocoplus,
            "j_regressor_h36m": h36m}


class Model(NamedTuple):
    v_template: torch.Tensor
    shapedirs: torch.Tensor
    posedirs: torch.Tensor
    j_regressor: torch.Tensor
    lbs_weights: torch.Tensor
    faces: torch.Tensor
    j_regressor_extra: torch.Tensor
    j_regressor_cocoplus: torch.Tensor
    j_regressor_h36m: torch.Tensor
    extra_ids: torch.Tensor


def load(device) -> Model:
    a = synthesize()
    t = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
         for k, v in a.items() if k != "faces"}
    return Model(faces=torch.as_tensor(a["faces"], device=device),
                 extra_ids=torch.as_tensor(EXTRA_JOINT_VERTEX_IDS,
                                           device=device), **t)


def _chain(rotmats: torch.Tensor, joints: torch.Tensor):
    b = rotmats.shape[0]
    parent = torch.as_tensor(PARENTS[1:], device=joints.device)
    rel = joints - torch.cat([torch.zeros_like(joints[:, :1]),
                              joints[:, parent]], dim=1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=rotmats.device
                          ).expand(b, 1, 4)

    def make44(r, t):
        return torch.cat([torch.cat([r, t[..., None]], -1), bottom], -2)

    world = [make44(rotmats[:, 0], rel[:, 0])]
    for j in range(1, NUM_JOINTS):
        world.append(matmul(world[PARENTS[j]], make44(rotmats[:, j],
                                                      rel[:, j])))
    world = torch.stack(world, 1)
    corr = einsum("bjxy,bjy->bjx", world[..., :3, :3], joints)
    rel_t = torch.cat([world[..., :3, :3],
                       (world[..., :3, 3] - corr)[..., None]], -1)
    return world[..., :3, 3], rel_t


def forward(m: Model, betas, body_rot, orient_rot):
    """(vertices (B, 6890, 3), joints (B, 90, 3)) from betas (B, 10) and
    rotation matrices (B, 23, 3, 3), (B, 1, 3, 3)."""
    b = betas.shape[0]
    rot = torch.cat([orient_rot, body_rot], 1)
    v_shaped = m.v_template[None] + einsum("bl,vcl->bvc", betas,
                                           m.shapedirs)
    joints = einsum("jv,bvc->bjc", m.j_regressor, v_shaped)
    eye = torch.eye(3, device=rot.device)
    pose_feat = (body_rot - eye).reshape(b, 9 * NUM_BODY_JOINTS)
    v_posed = v_shaped + matmul(pose_feat, m.posedirs).reshape(b, -1, 3)
    posed_joints, rel_t = _chain(rot, joints)
    t_blend = einsum("vj,bjxy->bvxy", m.lbs_weights, rel_t)
    verts = einsum("bvxy,bvy->bvx", t_blend[..., :3], v_posed) \
        + t_blend[..., 3]
    all_joints = torch.cat([
        posed_joints, verts[:, m.extra_ids],
        einsum("jv,bvc->bjc", m.j_regressor_extra, verts),
        einsum("jv,bvc->bjc", m.j_regressor_cocoplus, verts),
        einsum("jv,bvc->bjc", m.j_regressor_h36m, verts)], 1)
    return verts, all_joints


def translation(cam_wp: torch.Tensor, res: float) -> torch.Tensor:
    """Weak-perspective [s, tx, ty] → perspective [tx, ty, 2f/(res·s)]."""
    tz = 2.0 * FOCAL_LENGTH / (res * cam_wp[..., 0] + 1e-9)
    return torch.stack([cam_wp[..., 1], cam_wp[..., 2], tz], -1)


def project(points: torch.Tensor, transl: torch.Tensor, wh: int):
    """(B, N, 3) points → (B, N, 2) pixels: identity rotation, focal
    5000, principal point at wh/2."""
    p = points + transl[:, None, :]
    xy = p[..., :2] / p[..., 2:3]
    return xy * FOCAL_LENGTH + wh / 2.0


def keypoints(joints: torch.Tensor, cam_wp: torch.Tensor, wh: int):
    """(B, 17, 2) KP-RCNN keypoints in px: the orthographic projection
    s·(x + t) mapped from [-1, 1] to [0, wh]."""
    s, t = cam_wp[..., 0:1], cam_wp[..., 1:3]
    j = s[..., None] * (joints[..., :2] + t[..., None, :])
    return (j[:, list(SMPL_TO_KPRCNN)] + 1.0) * (wh / 2.0)


def rodrigues(aa: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(..., 3) axis-angle → (..., 3, 3)."""
    angle = torch.sqrt(torch.sum(aa * aa, -1, keepdim=True) + eps * eps)
    axis = aa / angle
    sin, cos = torch.sin(angle)[..., None], torch.cos(angle)[..., None]
    kx, ky, kz = axis.unbind(-1)
    z = torch.zeros_like(kx)
    k = torch.stack([torch.stack([z, -kz, ky], -1),
                     torch.stack([kz, z, -kx], -1),
                     torch.stack([-ky, kx, z], -1)], -2)
    return torch.eye(3, device=aa.device) + sin * k + (1.0 - cos) * (k @ k)
