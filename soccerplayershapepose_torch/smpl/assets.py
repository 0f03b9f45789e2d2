"""SMPL model assets: the ``.npz`` loader and the synthetic stand-in.

Counterpart of ``soccerplayershapepose_tpu/smpl/assets.py``. The real SMPL
blobs are absent, so :func:`synthesize_assets` builds the same deterministic
stand-in (6890 verts, 13776 faces, 24 joints, 10 betas, 207 pose
blendshapes) from the same ``np.random.RandomState`` draws, in the same
order, so both packages compute on identical numbers.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from soccerplayershapepose_torch import config as cfg


@dataclasses.dataclass(frozen=True)
class SMPLAssets:
    """SMPL model tensors (fp32, faces int64) on one device."""

    v_template: torch.Tensor        # (V, 3)
    shapedirs: torch.Tensor         # (V, 3, 10)
    posedirs: torch.Tensor          # (207, V*3), row-major (v, xyz)
    j_regressor: torch.Tensor       # (24, V)
    lbs_weights: torch.Tensor       # (V, 24)
    faces: torch.Tensor             # (F, 3) int64
    extra_joint_vertex_ids: torch.Tensor   # (21,) int64
    j_regressor_extra: torch.Tensor        # (9, V)
    j_regressor_cocoplus: torch.Tensor     # (19, V)
    j_regressor_h36m: torch.Tensor         # (17, V)
    mean_pose_rot6d: torch.Tensor          # (24*6,)
    mean_shape: torch.Tensor               # (10,)
    parents: tuple = cfg.SMPL_PARENTS

    def to(self, device) -> "SMPLAssets":
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self) if f.name != "parents"}
        return SMPLAssets(parents=self.parents, **moved)

    @classmethod
    def from_numpy(cls, arrays: dict, parents=cfg.SMPL_PARENTS,
                   device="cpu") -> "SMPLAssets":
        """Build from numpy arrays keyed by field name."""
        ints = ("faces", "extra_joint_vertex_ids")
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name == "parents":
                continue
            a = np.asarray(arrays[f.name])
            dtype = torch.int64 if f.name in ints else torch.float32
            kw[f.name] = torch.as_tensor(
                a.astype(np.int64 if f.name in ints else np.float32),
                dtype=dtype).to(device).contiguous()
        return cls(parents=tuple(int(p) for p in parents), **kw)


def _sphere_mesh(n_rings: int = 82, n_cols: int = 84):
    """Closed UV sphere with V = rings·cols + 2 = 6890 and F = 13776."""
    v = np.zeros((n_rings * n_cols + 2, 3), dtype=np.float64)
    v[0] = (0.0, 1.0, 0.0)
    v[-1] = (0.0, -1.0, 0.0)
    idx = 1
    for r in range(n_rings):
        phi = np.pi * (r + 1) / (n_rings + 1)
        for c in range(n_cols):
            theta = 2 * np.pi * c / n_cols
            v[idx] = (np.sin(phi) * np.cos(theta), np.cos(phi),
                      np.sin(phi) * np.sin(theta))
            idx += 1

    def ring_vert(r, c):
        return 1 + r * n_cols + (c % n_cols)

    faces = []
    for c in range(n_cols):
        faces.append((0, ring_vert(0, c + 1), ring_vert(0, c)))
    for r in range(n_rings - 1):
        for c in range(n_cols):
            a, b = ring_vert(r, c), ring_vert(r, c + 1)
            d, e = ring_vert(r + 1, c), ring_vert(r + 1, c + 1)
            faces.append((a, b, e))
            faces.append((a, e, d))
    last = n_rings * n_cols + 1
    for c in range(n_cols):
        faces.append((last, ring_vert(n_rings - 1, c),
                      ring_vert(n_rings - 1, c + 1)))
    return v, np.asarray(faces, dtype=np.int32)


# Rest-pose joints of a rough T-posed body (x right, y up, z forward), in
# SMPL joint order.
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


def synthesize_arrays(seed: int = 0) -> dict:
    """The synthetic model as numpy arrays (same draws as the JAX package)."""
    rng = np.random.RandomState(seed)
    v_sphere, faces = _sphere_mesh()
    if v_sphere.shape[0] != cfg.NUM_VERTS or faces.shape[0] != cfg.NUM_FACES:
        raise AssertionError("sphere mesh does not have SMPL's sizes")
    v_template = v_sphere * np.array([0.45, 0.85, 0.22]) + np.array([0.0, -0.15, 0.0])
    joints = _JOINT_POSITIONS

    d2 = ((v_template[:, None, :] - joints[None, :, :]) ** 2).sum(-1)
    logits = -d2 / 0.02
    logits -= logits.max(axis=1, keepdims=True)
    w = np.exp(logits)
    lbs_weights = w / w.sum(axis=1, keepdims=True)

    j_regressor = np.zeros((cfg.NUM_JOINTS, cfg.NUM_VERTS))
    for j in range(cfg.NUM_JOINTS):
        nearest = np.argsort(d2[:, j])[:32]
        wj = np.exp(-d2[nearest, j] / 0.01)
        j_regressor[j, nearest] = wj / wj.sum()

    def _sparse_regressor(n_joints: int, spread: float = 0.02) -> np.ndarray:
        reg = np.zeros((n_joints, cfg.NUM_VERTS))
        anchors = rng.randint(0, cfg.NUM_VERTS, size=n_joints)
        for j, a in enumerate(anchors):
            d = ((v_template - v_template[a]) ** 2).sum(-1)
            nearest = np.argsort(d)[:24]
            wj = np.exp(-d[nearest] / spread)
            reg[j, nearest] = wj / wj.sum()
        return reg

    # Draw order matters: shapedirs, posedirs, then the three regressors.
    shapedirs = rng.randn(cfg.NUM_VERTS, 3, cfg.NUM_BETAS) * 0.01
    posedirs = rng.randn(cfg.NUM_POSE_BLENDSHAPES, cfg.NUM_VERTS * 3) * 0.001
    extra = _sparse_regressor(cfg.NUM_EXTRA_JOINTS)
    cocoplus = _sparse_regressor(cfg.NUM_COCOPLUS_JOINTS)
    h36m = _sparse_regressor(cfg.NUM_H36M_JOINTS)
    mean_pose = np.tile(np.array([1, 0, 0, 1, 0, 0], dtype=np.float32),
                        cfg.NUM_JOINTS)
    return {
        "v_template": v_template, "shapedirs": shapedirs,
        "posedirs": posedirs, "j_regressor": j_regressor,
        "lbs_weights": lbs_weights, "faces": faces,
        "extra_joint_vertex_ids": np.asarray(cfg.EXTRA_JOINT_VERTEX_IDS),
        "j_regressor_extra": extra, "j_regressor_cocoplus": cocoplus,
        "j_regressor_h36m": h36m, "mean_pose_rot6d": mean_pose,
        "mean_shape": np.zeros((cfg.NUM_BETAS,), np.float32),
    }


def synthesize_assets(seed: int = 0, device="cpu") -> SMPLAssets:
    """Deterministic SMPL-compatible synthetic model on ``device``."""
    return SMPLAssets.from_numpy(synthesize_arrays(seed), device=device)


def load_assets(model_dir: Optional[str] = None,
                gender: str = "neutral",
                mean_params_path: Optional[str] = None,
                extra_regressor_dir: Optional[str] = None,
                device="cpu") -> SMPLAssets:
    """Load ``SMPL_<GENDER>.npz`` / ``smpl_<gender>.npz`` from ``model_dir``
    if present, else synthesize. Extra regressors and the IEF mean
    parameters are read when present, as in the JAX loader's npz branch."""
    data = None
    if model_dir:
        for name in (f"SMPL_{gender.upper()}.npz", f"smpl_{gender}.npz"):
            path = os.path.join(model_dir, name)
            if os.path.exists(path):
                data = dict(np.load(path, allow_pickle=True))
                break
    if data is None:
        return synthesize_assets(device=device)

    def _dense(x):
        return np.asarray(x.todense() if hasattr(x, "todense") else x,
                          np.float64)

    synth = synthesize_arrays()

    def _load_npy(fname, fallback):
        if extra_regressor_dir:
            p = os.path.join(extra_regressor_dir, fname)
            if os.path.exists(p):
                return np.load(p).astype(np.float32)
        return fallback

    mean_pose, mean_shape = synth["mean_pose_rot6d"], synth["mean_shape"]
    if mean_params_path and os.path.exists(mean_params_path):
        mp = np.load(mean_params_path)
        mean_pose = mp["pose"].astype(np.float32)
        mean_shape = mp["shape"].astype(np.float32)

    parents = np.asarray(data["kintree_table"])[0].astype(np.int64)
    parents[0] = -1
    arrays = {
        "v_template": _dense(data["v_template"]),
        "shapedirs": _dense(data["shapedirs"])[..., :cfg.NUM_BETAS],
        "posedirs": _dense(data["posedirs"]).reshape(cfg.NUM_VERTS * 3, -1).T,
        "j_regressor": _dense(data["J_regressor"]),
        "lbs_weights": _dense(data["weights"]),
        "faces": np.asarray(data.get("f", data.get("faces")), np.int32),
        "extra_joint_vertex_ids": np.asarray(cfg.EXTRA_JOINT_VERTEX_IDS),
        "j_regressor_extra": _load_npy("J_regressor_extra.npy",
                                       synth["j_regressor_extra"]),
        "j_regressor_cocoplus": _load_npy("cocoplus_regressor.npy",
                                          synth["j_regressor_cocoplus"]),
        "j_regressor_h36m": _load_npy("J_regressor_h36m.npy",
                                      synth["j_regressor_h36m"]),
        "mean_pose_rot6d": mean_pose,
        "mean_shape": mean_shape,
    }
    return SMPLAssets.from_numpy(arrays, parents=tuple(parents), device=device)
