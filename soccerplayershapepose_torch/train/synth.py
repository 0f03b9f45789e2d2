"""Synthetic SMPL crops: the geometry labels of ``train/synth.py``.

Counterpart of the geometry branch of
``soccerplayershapepose_tpu/train/synth.py:synth_crop_batch``
(``with_image=False``): a random soccer body per crop, an occluding second
body in front of or behind it, both z-buffered at the crop resolution (the
labelled player's visible silhouette) and again at stride 4 (part ids and
UV), the 17 KP-RCNN joints and their visibility.

Randomness is explicit. A sampler draws everything random from a
``torch.Generator`` into a small NamedTuple (:func:`sample_crop_draws`), and
:func:`render_crop_batch` is a deterministic function of those draws, so a
test can feed it the draws of the JAX key stream. One coupling of that
stream is kept: the JAX function takes the sign of the occluder's depth
offset from ``bernoulli(keys[6], 0.5)`` and its magnitude from
``uniform(keys[6], 0.3, 1.2)``, one uniform draw for both, so a nearer
occluder moves by [0.3, 0.75) and a farther one by [0.75, 1.2);
:func:`occluder_depth_offset` derives both from one uniform too.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.nn import functional as F

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.ops.camera import (
    perspective_project, weak_perspective_to_translation)
from soccerplayershapepose_torch.ops.rotations import batch_rodrigues
from soccerplayershapepose_torch.render.attribute import rasterize_attributes
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.smpl.model import smpl_forward

# models/perception.py of the JAX package: DensePose part count and the
# stride of the part/UV head.
NUM_PARTS = 24
STRIDE = 4


def vertex_parts(assets: SMPLAssets) -> torch.Tensor:
    """(V,) dominant-joint part id in 0..23."""
    return torch.argmax(assets.lbs_weights, dim=-1).to(torch.int32)


def vertex_uv(assets: SMPLAssets) -> torch.Tensor:
    """(V, 2) pseudo-UV: the template's x and y normalised to [0, 1]."""
    v = assets.v_template
    lo = torch.amin(v, dim=0)
    hi = torch.amax(v, dim=0)
    n = (v - lo) / torch.clamp(hi - lo, min=1e-6)
    return torch.stack([n[:, 0], n[:, 1]], dim=-1)


# ---------------------------------------------------------------------------
# Random bodies
# ---------------------------------------------------------------------------

# Per-body-joint axis-angle noise scales (23, 3); index i is SMPL joint i+1.
_POSE_SCALE = np.full((23, 3), 0.12, np.float32)
_POSE_SCALE[[0, 1]] = (0.55, 0.25, 0.25)      # hips
_POSE_SCALE[[3, 4]] = (0.65, 0.10, 0.10)      # knees (flexion-dominant)
_POSE_SCALE[[6, 7]] = (0.30, 0.15, 0.15)      # ankles
_POSE_SCALE[[15, 16]] = (0.35, 0.45, 0.45)    # shoulders
_POSE_SCALE[[17, 18]] = (0.25, 0.60, 0.30)    # elbows
_POSE_SCALE[[19, 20]] = (0.25, 0.25, 0.25)    # wrists


class BodyDraws(NamedTuple):
    """The random draws of one batch of bodies (``random_smpl_params``)."""
    pose_noise: torch.Tensor   # (B, 23, 3) standard normal
    energy: torch.Tensor       # (B, 1, 1) U[0.4, 1.5): articulation scale
    tilt: torch.Tensor         # (B, 1) standard normal: pitch noise
    sway: torch.Tensor         # (B, 2) standard normal: yaw/roll noise
    yaw: torch.Tensor          # (B,) U[-π, π)
    shape_noise: torch.Tensor  # (B, 10) standard normal
    cam_wp: torch.Tensor       # (B, 3): s U[0.5, 1.1), tx, ty U[-0.2, 0.2)


class OccluderDraws(NamedTuple):
    body: BodyDraws
    side: torch.Tensor         # (B,) +1 or -1: which crop edge
    offset: torch.Tensor       # (B,) U[0.35, 0.8): |tx| from the player
    dz_u: torch.Tensor         # (B,) U[0, 1): depth offset, sign and size
    present: torch.Tensor      # (B, 1) 1 in the crop, 0 moved off-screen


class CropDraws(NamedTuple):
    body: BodyDraws
    occluder: OccluderDraws


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def _normal(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def sample_body_draws(gen: torch.Generator, b: int) -> BodyDraws:
    return BodyDraws(
        pose_noise=_normal(gen, (b, 23, 3)),
        energy=_uniform(gen, (b, 1, 1), 0.4, 1.5),
        tilt=_normal(gen, (b, 1)), sway=_normal(gen, (b, 2)),
        yaw=_uniform(gen, (b,), -np.pi, np.pi),
        shape_noise=_normal(gen, (b, 10)),
        cam_wp=torch.stack([_uniform(gen, (b,), 0.5, 1.1),
                            _uniform(gen, (b,), -0.2, 0.2),
                            _uniform(gen, (b,), -0.2, 0.2)], dim=-1))


def sample_crop_draws(gen: torch.Generator, b: int) -> CropDraws:
    """Everything random about one batch of crops, on the generator's
    device."""
    body = sample_body_draws(gen, b)
    occ = OccluderDraws(
        body=sample_body_draws(gen, b),
        side=torch.where(_uniform(gen, (b,), 0.0, 1.0) < 0.5, 1.0, -1.0),
        offset=_uniform(gen, (b,), 0.35, 0.8),
        dz_u=_uniform(gen, (b,), 0.0, 1.0),
        present=(_uniform(gen, (b, 1), 0.0, 1.0) < 0.45).to(torch.float32))
    return CropDraws(body, occ)


def draws_to(draws, device: torch.device):
    """A draws tuple (nested NamedTuples of tensors) on ``device``."""
    if isinstance(draws, torch.Tensor):
        return draws.to(device)
    return type(draws)(*(draws_to(d, device) for d in draws))


def smpl_params_from_draws(d: BodyDraws):
    """Plausible soccer bodies from their draws (the deterministic half of
    ``random_smpl_params``): ``(body_rotmats (B, 23, 3, 3), orient_rotmats
    (B, 1, 3, 3), betas (B, 10), cam_wp (B, 3))``. The global orient is
    upright (π about x) with pitch/roll noise, composed with the yaw."""
    b = d.pose_noise.shape[0]
    scale = torch.as_tensor(_POSE_SCALE, device=d.pose_noise.device)
    body_aa = d.pose_noise * scale[None] * d.energy
    body_aa[:, [3, 4], 0] = torch.abs(body_aa[:, [3, 4], 0])  # knees flex
    body_rm = batch_rodrigues(body_aa.reshape(-1, 3)).reshape(b, 23, 3, 3)
    upright = batch_rodrigues(torch.cat(
        [torch.full((b, 1), np.pi, device=d.tilt.device) + d.tilt * 0.25,
         d.sway * 0.15], dim=-1))
    zero = torch.zeros_like(d.yaw)
    yaw_rm = batch_rodrigues(torch.stack([zero, d.yaw, zero], dim=-1))
    orient_rm = torch.einsum("bij,bjk->bik", upright, yaw_rm)[:, None]
    return body_rm, orient_rm, d.shape_noise * 1.5, d.cam_wp


def occluder_depth_offset(dz_u: torch.Tensor) -> torch.Tensor:
    """One uniform → the occluder's depth offset: nearer (negative) by
    [0.3, 0.75) when u < 0.5, farther by [0.75, 1.2) otherwise, with the
    fp32 steps of ``jax.random.uniform(key, minval=0.3, maxval=1.2)``."""
    lo, hi = np.float32(0.3), np.float32(1.2)
    mag = torch.clamp(dz_u * (hi - lo) + lo, min=float(lo))
    return torch.where(dz_u < 0.5, -1.0, 1.0) * mag


# ---------------------------------------------------------------------------
# Crop batches
# ---------------------------------------------------------------------------

def render_crop_batch(assets: SMPLAssets, draws: CropDraws, wh: int = 256,
                      return_params: bool = False) -> dict:
    """One batch of crop labels from its draws, on the assets' device.

    Returns ``silhouette (B, wh, wh)`` {0, 1}, the labelled player's visible
    region; ``joints2d (B, 17, 2)`` px; ``kp_visible (B, 17)`` {0, 1}, in
    the crop and on a player pixel; ``part (B, wh/4, wh/4)`` int32 0..24;
    ``uv (B, wh/4, wh/4, 2)``; with ``return_params`` also the generating
    ``body_pose``, ``global_orient``, ``betas`` and ``cam_wp``.
    """
    if wh % STRIDE:
        raise ValueError(f"wh must be a multiple of {STRIDE}, got {wh}")
    scene = crop_scene(assets, draws_to(draws, assets.faces.device), wh)
    batch = crop_labels(assets, scene["verts2d"], scene["verts_z"],
                        scene["faces"], scene["is_player"],
                        scene["joints2d"], wh)
    if return_params:
        batch.update({k: scene[k] for k in ("body_pose", "global_orient",
                                            "betas", "cam_wp")})
    return batch


def crop_scene(assets: SMPLAssets, draws: CropDraws, wh: int) -> dict:
    """The geometry of a crop batch: the player and the occluder posed and
    projected into the wh² crop. Returns ``verts2d (B, 2V, 2)``,
    ``verts_z (B, 2V)``, ``faces (2F, 3)``, ``is_player (B, 2V, 1)`` (the
    player's vertices first), the player's ``joints2d (B, 17, 2)`` and its
    parameters.
    """
    dev = assets.faces.device
    b = draws.body.pose_noise.shape[0]
    body_rm, orient_rm, betas, cam_wp = smpl_params_from_draws(draws.body)
    out = smpl_forward(assets, betas, body_rm, orient_rm)
    transl = weak_perspective_to_translation(cam_wp, cfg.FOCAL_LENGTH, wh)
    verts2d = perspective_project(out.vertices, None, transl,
                                  focal_length=cfg.FOCAL_LENGTH, img_wh=wh)
    verts_z = out.vertices[..., 2] + transl[:, None, 2]
    joints2d = perspective_project(
        out.joints[:, list(cfg.SMPL_TO_KPRCNN_MAP)], None, transl,
        focal_length=cfg.FOCAL_LENGTH, img_wh=wh)
    # The occluder: its own body, beside the player towards a crop edge, in
    # front of or behind it (the z-buffer decides what is visible).
    occ = draws.occluder
    o_body, o_orient, o_betas, o_cam = smpl_params_from_draws(occ.body)
    o_cam = o_cam.clone()
    o_cam[:, 1] = cam_wp[:, 1] + occ.side * occ.offset
    o_out = smpl_forward(assets, o_betas, o_body, o_orient)
    o_transl = weak_perspective_to_translation(o_cam, cfg.FOCAL_LENGTH, wh)
    o_transl[:, 2] += occluder_depth_offset(occ.dz_u)
    o_v2d = perspective_project(o_out.vertices, None, o_transl,
                                focal_length=cfg.FOCAL_LENGTH, img_wh=wh)
    o_z = o_out.vertices[..., 2] + o_transl[:, None, 2]
    o_v2d = o_v2d + (1.0 - occ.present[..., None]) * 1e5  # absent: away
    v = assets.v_template.shape[0]
    return {"verts2d": torch.cat([verts2d, o_v2d], dim=1),
            "verts_z": torch.cat([verts_z, o_z], dim=1),
            "faces": torch.cat([assets.faces, assets.faces + v]),
            "is_player": torch.cat([torch.ones((b, v, 1), device=dev),
                                    torch.zeros((b, v, 1), device=dev)],
                                   dim=1),
            "joints2d": joints2d, "body_pose": body_rm,
            "global_orient": orient_rm, "betas": betas, "cam_wp": cam_wp}


def pass_attributes(assets: SMPLAssets, is_player: torch.Tensor):
    """The per-vertex attributes of the two z-buffer passes over a scene of
    n bodies (``is_player`` (B, n·V, 1)): the full-resolution pass's
    (B, n·V, 4) [zero colour ×3, ownership] (the colour channels keep the
    JAX package's layout) and the stride-4 pass's (B, n·V, 27)
    [part one-hot ×24, UV ×2, ownership]."""
    b, nv, _ = is_player.shape
    n_bodies = nv // assets.v_template.shape[0]
    full = torch.cat([torch.zeros((b, nv, 3), device=is_player.device),
                      is_player], dim=-1)
    small = torch.cat([
        F.one_hot(vertex_parts(assets).to(torch.long), NUM_PARTS).to(
            torch.float32), vertex_uv(assets)], dim=-1)       # (V, 26)
    small = torch.cat([small.repeat(n_bodies, 1)[None].expand(b, -1, -1),
                       is_player], dim=-1)
    return full, small


def crop_labels(assets: SMPLAssets, verts2d: torch.Tensor,
                verts_z: torch.Tensor, faces: torch.Tensor,
                is_player: torch.Tensor, joints2d: torch.Tensor,
                wh: int) -> dict:
    """The labels of a crop scene: two z-buffered passes (K3 on the card)
    and the joint visibility; see :func:`render_crop_batch`."""
    b = verts2d.shape[0]
    dev = verts2d.device
    full_attrs, attr_small = pass_attributes(assets, is_player)
    full, full_mask = rasterize_attributes(verts2d, verts_z, full_attrs,
                                           faces, wh)
    sil = (full_mask & (full[..., 3] > 0.5)).to(torch.float32)

    small = wh // STRIDE
    small_attr, small_mask = rasterize_attributes(
        verts2d * (small / wh), verts_z, attr_small, faces, small)
    own_small = small_mask & (small_attr[..., -1] > 0.5)
    part = torch.where(own_small,
                       torch.argmax(small_attr[..., :NUM_PARTS], dim=-1) + 1,
                       0).to(torch.int32)
    uv = small_attr[..., NUM_PARTS:NUM_PARTS + 2] * own_small[..., None]

    # Joint visibility: in the crop and on a player pixel of the 7×7-dilated
    # silhouette (so joints on the boundary count).
    ji = torch.clamp(torch.round(joints2d).to(torch.long), 0, wh - 1)
    vis_img = F.max_pool2d(sil[:, None], 7, stride=1, padding=3)[:, 0]
    on_body = vis_img[torch.arange(b, device=dev)[:, None], ji[..., 1],
                      ji[..., 0]]
    in_frame = ((joints2d[..., 0] >= 0) & (joints2d[..., 0] < wh)
                & (joints2d[..., 1] >= 0) & (joints2d[..., 1] < wh))
    return {"silhouette": sil, "joints2d": joints2d,
            "kp_visible": ((on_body > 0.5) & in_frame).to(torch.float32),
            "part": part, "uv": uv}
