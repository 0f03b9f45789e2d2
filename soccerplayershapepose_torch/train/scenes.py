"""Synthetic broadcast scenes: multi-view players and tracks with known 3-D.

Counterpart of ``soccerplayershapepose_tpu/train/scenes.py`` (the scene
factory and its tree writer):

* a scene is N players with correlated parameters: a shared base pose mixed
  into each player's own sample (a team action), global orientations that
  face a shared ball point, and virtual 1920 × 1080 broadcast-frame boxes
  from pitch positions with a perspective size gradient;
* each player is rendered from V narrow camera azimuths plus one broad
  (broadcast-like) azimuth: the same body, its global orient rotated;
* a track is T frames of one moving body per player: the pose interpolates
  between two action poses, the yaw drifts, the betas are fixed and the
  camera jitters per frame.

Every view is z-buffered at wh² in one pass for all its players (K3 on the
card), and the track batch in one pass for all its frames.

Randomness is explicit, as in ``train/synth.py``: samplers draw into
NamedTuples and the render functions are deterministic in those draws. Two
draws that the JAX package turns into host floats are draws here too: each
narrow view's azimuth noise (azimuth 2πv/V + 0.12·n, n standard normal) and
the broad view's azimuth (U[−π, π)). The geometry is drawn first and the
appearance (for images) after it, from ``image_gen`` when given, so the
geometry stream of a generator is the same with or without images.

:func:`write_scene_tree` writes a scene to the stage drivers' folder
layout. The proxies it writes may carry the detector-noise corruption,
from explicit draws (one per view, :func:`sample_tree_corruption`): the
JAX writer keys each view's corruption by Python's ``hash`` of a string
tuple, which is salted per process, so its corrupted trees differ from
process to process; the port's are fixed by the generator's seed.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.io import formats as io
from soccerplayershapepose_torch.ops.camera import (
    perspective_project, weak_perspective_to_translation)
from soccerplayershapepose_torch.ops.rotations import batch_rodrigues
from soccerplayershapepose_torch.render.attribute import rasterize_attributes
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.smpl.model import smpl_forward
from soccerplayershapepose_torch.train.synth import (
    _POSE_SCALE, AppearanceDraws, _kit_vertex_colors, _normal,
    _shaded_colors, _uniform, compose_image, draws_to,
    sample_appearance_draws)
from soccerplayershapepose_torch.train.straps import (
    CorruptionDraws, corrupt_proxy_inputs, sample_corruption_draws)

# The virtual broadcast frame the scene boxes live in (pixels).
FRAME_W, FRAME_H = 1920, 1080
NARROW_SCALE = (0.65, 1.0)     # close-up weak-perspective scales
BROAD_SCALE = (0.55, 0.85)     # broadcast-like scales


class SceneDraws(NamedTuple):
    """The random draws of ``synth_scene_params`` for N players."""
    base_noise: torch.Tensor    # (1, 23, 3) standard normal: team action
    base_energy: torch.Tensor   # (1, 1, 1) U[0.4, 1.5)
    indiv_noise: torch.Tensor   # (N, 23, 3) standard normal
    indiv_energy: torch.Tensor  # (N, 1, 1) U[0.4, 1.5)
    shape_noise: torch.Tensor   # (N, 10) standard normal
    pitch_xy: torch.Tensor      # (N, 2) U[0.05, 0.95)
    ball_xy: torch.Tensor       # (2,) U[0.15, 0.85)
    yaw_noise: torch.Tensor     # (N,) standard normal


class OrientDraws(NamedTuple):
    """The upright noise of ``orient_for_view`` for n bodies."""
    tilt: torch.Tensor          # (n, 1) standard normal: about x
    sway: torch.Tensor          # (n, 2) standard normal: about y and z


class ViewDraws(NamedTuple):
    orient: OrientDraws
    scale: torch.Tensor         # (N,) U[lo, hi): the camera's scale
    offset: torch.Tensor        # (N, 2) U[-0.15, 0.15): its translation
    appearance: Optional[AppearanceDraws]   # None: no image


class SceneViewsDraws(NamedTuple):
    scene: SceneDraws
    az_noise: torch.Tensor      # (V,) standard normal
    views: Tuple[ViewDraws, ...]
    broad_az: Optional[torch.Tensor]   # () U[-π, π); None: no broad view
    broad: Optional[ViewDraws]


class TrackDraws(NamedTuple):
    """Everything random about N tracks of T frames."""
    pose_noise: torch.Tensor    # (2, N, 23, 3) standard normal: two actions
    energy: torch.Tensor        # (2, N, 1, 1) U[0.4, 1.5)
    yaw0: torch.Tensor          # (N,) U[-π, π)
    dyaw: torch.Tensor          # (N,) standard normal: yaw drift
    orient: OrientDraws         # (N·T, ·) per frame
    shape_noise: torch.Tensor   # (N, 10) standard normal
    scale: torch.Tensor         # (N, 1) U[0.6, 0.95)
    scale_noise: torch.Tensor   # (N, T) standard normal
    txy: torch.Tensor           # (N, T, 2) standard normal
    appearance: Optional[AppearanceDraws]   # (N·T images); None: no image


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

def sample_scene_draws(gen: torch.Generator, n: int) -> SceneDraws:
    return SceneDraws(
        base_noise=_normal(gen, (1, 23, 3)),
        base_energy=_uniform(gen, (1, 1, 1), 0.4, 1.5),
        indiv_noise=_normal(gen, (n, 23, 3)),
        indiv_energy=_uniform(gen, (n, 1, 1), 0.4, 1.5),
        shape_noise=_normal(gen, (n, 10)),
        pitch_xy=_uniform(gen, (n, 2), 0.05, 0.95),
        ball_xy=_uniform(gen, (2,), 0.15, 0.85),
        yaw_noise=_normal(gen, (n,)))


def sample_orient_draws(gen: torch.Generator, n: int) -> OrientDraws:
    return OrientDraws(tilt=_normal(gen, (n, 1)), sway=_normal(gen, (n, 2)))


def _view_geometry(gen, n, lo, hi):
    return ViewDraws(orient=sample_orient_draws(gen, n),
                     scale=_uniform(gen, (n,), lo, hi),
                     offset=_uniform(gen, (n, 2), -0.15, 0.15),
                     appearance=None)


def _appearance(gen, n, wh):
    return sample_appearance_draws(gen, n, wh, domain_rand=True,
                                   occluders=False)


def sample_scene_views_draws(gen: torch.Generator, n_players: int = 6,
                             n_views: int = 3, broad: bool = True,
                             image_wh: Optional[int] = None,
                             image_gen: Optional[torch.Generator] = None
                             ) -> SceneViewsDraws:
    """The draws of one scene of ``n_players`` seen from ``n_views`` narrow
    views (and the broad one): the geometry from ``gen``, then, with
    ``image_wh``, the appearance of each view's image_wh² images from
    ``image_gen`` (default ``gen``)."""
    scene = sample_scene_draws(gen, n_players)
    az_noise = _normal(gen, (n_views,))
    views = [_view_geometry(gen, n_players, *NARROW_SCALE)
             for _ in range(n_views)]
    broad_az = bview = None
    if broad:
        broad_az = _uniform(gen, (), -np.pi, np.pi)
        bview = _view_geometry(gen, n_players, *BROAD_SCALE)
    if image_wh is not None:
        ig = gen if image_gen is None else image_gen
        views = [v._replace(appearance=_appearance(ig, n_players, image_wh))
                 for v in views]
        if bview is not None:
            bview = bview._replace(
                appearance=_appearance(ig, n_players, image_wh))
    return SceneViewsDraws(scene, az_noise, tuple(views), broad_az, bview)


def sample_track_draws(gen: torch.Generator, n_players: int = 4,
                       n_frames: int = 8, image_wh: Optional[int] = None,
                       image_gen: Optional[torch.Generator] = None
                       ) -> TrackDraws:
    """The draws of ``n_players`` tracks of ``n_frames`` frames; with
    ``image_wh`` also the appearance of the image_wh² frames' crops, from
    ``image_gen`` (default ``gen``)."""
    n, t = n_players, n_frames
    draws = TrackDraws(
        pose_noise=_normal(gen, (2, n, 23, 3)),
        energy=_uniform(gen, (2, n, 1, 1), 0.4, 1.5),
        yaw0=_uniform(gen, (n,), -np.pi, np.pi),
        dyaw=_normal(gen, (n,)),
        orient=sample_orient_draws(gen, n * t),
        shape_noise=_normal(gen, (n, 10)),
        scale=_uniform(gen, (n, 1), 0.6, 0.95),
        scale_noise=_normal(gen, (n, t)),
        txy=_normal(gen, (n, t, 2)),
        appearance=None)
    if image_wh is not None:
        draws = draws._replace(appearance=_appearance(
            gen if image_gen is None else image_gen, n * t, image_wh))
    return draws


# ---------------------------------------------------------------------------
# Scene parameters (correlated players)
# ---------------------------------------------------------------------------

def _knees_flex(body_aa: torch.Tensor) -> torch.Tensor:
    """Knees (body joints 3, 4) bend one way: |x| of their axis-angle."""
    body_aa = body_aa.clone()
    body_aa[..., [3, 4], 0] = torch.abs(body_aa[..., [3, 4], 0])
    return body_aa


def synth_scene_params(d: SceneDraws, pose_mix: float = 0.55) -> dict:
    """One scene's correlated SMPL parameters and broadcast geometry.

    Each player's body pose (axis-angle) is (1 − w)·base + w·own with w =
    ``pose_mix``; each player's yaw points at the ball from its pitch
    position (yaw 0 faces the camera, −y), plus noise; its box in the
    1920 × 1080 frame grows toward the near edge (y → 1).

    Returns ``body_pose (N, 23, 3, 3), betas (N, 10), yaw (N,), pitch_xy
    (N, 2), ball_xy (2,), boxes (N, 4)`` [x1, y1, x2, y2] px.
    """
    n = d.indiv_noise.shape[0]
    scale = torch.as_tensor(_POSE_SCALE, device=d.indiv_noise.device)[None]
    base_aa = d.base_noise * scale * d.base_energy
    indiv_aa = d.indiv_noise * scale * d.indiv_energy
    body_aa = _knees_flex((1.0 - pose_mix) * base_aa + pose_mix * indiv_aa)
    body_rm = batch_rodrigues(body_aa.reshape(-1, 3)).reshape(n, 23, 3, 3)
    dxy = d.ball_xy[None] - d.pitch_xy                        # (N, 2)
    yaw = torch.atan2(dxy[:, 0], -dxy[:, 1]) + d.yaw_noise * 0.25
    box_h = (0.12 + 0.22 * d.pitch_xy[:, 1]) * FRAME_H
    box_w = box_h * 0.42
    cx = d.pitch_xy[:, 0] * FRAME_W
    cy = (0.18 + 0.64 * d.pitch_xy[:, 1]) * FRAME_H
    boxes = torch.stack([cx - box_w / 2, cy - box_h / 2,
                         cx + box_w / 2, cy + box_h / 2], dim=-1)
    return {"body_pose": body_rm, "betas": d.shape_noise * 1.5, "yaw": yaw,
            "pitch_xy": d.pitch_xy, "ball_xy": d.ball_xy, "boxes": boxes}


def orient_for_view(d: OrientDraws, yaw: torch.Tensor,
                    azimuth: float) -> torch.Tensor:
    """(n, 1, 3, 3) global orients of bodies with facing ``yaw`` seen from
    a camera at ``azimuth``: upright (π about x, with noise) ∘ R_y(yaw +
    azimuth), the crop factory's convention."""
    n = yaw.shape[0]
    upright = batch_rodrigues(torch.cat(
        [torch.full((n, 1), np.pi, device=yaw.device) + d.tilt * 0.15,
         d.sway * 0.10], dim=-1))
    total = yaw + azimuth
    zero = torch.zeros_like(total)
    yaw_rm = batch_rodrigues(torch.stack([zero, total, zero], dim=-1))
    return torch.einsum("bij,bjk->bik", upright, yaw_rm)[:, None]


# ---------------------------------------------------------------------------
# View rendering
# ---------------------------------------------------------------------------

def view_geometry(assets: SMPLAssets, body_pose: torch.Tensor,
                  global_orient: torch.Tensor, betas: torch.Tensor,
                  cam_wp: torch.Tensor, wh: int) -> dict:
    """N posed bodies projected into their wh² crops by their
    weak-perspective cameras: ``vertices (N, V, 3)``, ``verts2d (N, V, 2)``
    px, ``verts_z (N, V)`` (the z-buffer's depths) and ``joints2d (N, 17,
    2)`` px, on the assets' device."""
    dev = assets.faces.device
    body_pose, global_orient, betas, cam_wp = (
        x.to(dev) for x in (body_pose, global_orient, betas, cam_wp))
    out = smpl_forward(assets, betas, body_pose, global_orient)
    transl = weak_perspective_to_translation(cam_wp, cfg.FOCAL_LENGTH, wh)
    verts2d = perspective_project(out.vertices, None, transl,
                                  focal_length=cfg.FOCAL_LENGTH, img_wh=wh)
    joints2d = perspective_project(
        out.joints[:, list(cfg.SMPL_TO_KPRCNN_MAP)], None, transl,
        focal_length=cfg.FOCAL_LENGTH, img_wh=wh)
    return {"vertices": out.vertices, "verts2d": verts2d,
            "verts_z": out.vertices[..., 2] + transl[:, None, 2],
            "joints2d": joints2d}


def render_view(assets: SMPLAssets, body_pose: torch.Tensor,
                global_orient: torch.Tensor, betas: torch.Tensor,
                cam_wp: torch.Tensor, wh: int = cfg.PROXY_REP_INPUT_WH,
                appearance: Optional[AppearanceDraws] = None) -> dict:
    """One camera view of N players, each in its own wh² crop, all
    z-buffered in one pass (K3 on the card).

    Returns ``silhouette (N, wh, wh)`` {0, 1} and ``joints2d (N, 17, 2)``
    px; with ``appearance`` (the draws of N wh² images) also ``image (N,
    wh, wh, 3)`` in [0, 1]: the shaded kit over a domain-randomised pitch,
    blurred and jittered.
    """
    dev = assets.faces.device
    geo = view_geometry(assets, body_pose, global_orient, betas, cam_wp, wh)
    if appearance is not None:
        appearance = draws_to(appearance, dev)
        colors = _shaded_colors(appearance.shading, geo["vertices"],
                                assets.faces,
                                _kit_vertex_colors(assets, appearance.kit))
    else:
        # The silhouette needs the coverage only: one zero channel.
        colors = torch.zeros(geo["vertices"].shape[:2] + (1,), device=dev)
    attrs, mask = rasterize_attributes(geo["verts2d"], geo["verts_z"],
                                       colors, assets.faces, wh)
    sil = mask.to(torch.float32)
    batch = {"silhouette": sil, "joints2d": geo["joints2d"]}
    if appearance is not None:
        batch["image"] = compose_image(attrs, sil, appearance)
    return batch


def synth_scene_views(assets: SMPLAssets, draws: SceneViewsDraws,
                      wh: int = cfg.PROXY_REP_INPUT_WH) -> dict:
    """One scene: its correlated parameters and V narrow views (and the
    broad one when the draws hold it), with images when the draws carry
    their appearance.

    Narrow cameras sit at evenly spread azimuths, 2πv/V plus noise, with
    close-up scales; the broad camera is one more azimuth at broadcast-like
    scales.

    Returns ``{"scene": synth_scene_params, "views": [view, ...],
    "broad": view}`` (``broad`` only with its draws); a view is
    :func:`render_view`'s dict plus ``global_orient (N, 1, 3, 3)``,
    ``cam_wp (N, 3)`` and ``azimuth`` (a float).
    """
    draws = draws_to(draws, assets.faces.device)
    scene = synth_scene_params(draws.scene)

    def one_view(vd: ViewDraws, azimuth: float) -> dict:
        orient = orient_for_view(vd.orient, scene["yaw"], azimuth)
        cam_wp = torch.cat([vd.scale[:, None], vd.offset], dim=-1)
        view = render_view(assets, scene["body_pose"], orient,
                           scene["betas"], cam_wp, wh=wh,
                           appearance=vd.appearance)
        view.update(global_orient=orient, cam_wp=cam_wp,
                    azimuth=float(azimuth))
        return view

    n_views = len(draws.views)
    views = [one_view(vd, 2.0 * np.pi * v / max(n_views, 1)
                      + float(draws.az_noise[v] * 0.12))
             for v, vd in enumerate(draws.views)]
    out = {"scene": scene, "views": views}
    if draws.broad is not None:
        out["broad"] = one_view(draws.broad, float(draws.broad_az))
    return out


def _linspace01(t: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, t)`` bit for bit: i · fp32(1 / (t − 1)), as
    XLA computes its i / (t − 1), then 1 (``torch.linspace`` rounds some
    interior points the other way)."""
    if t == 1:
        return torch.zeros((1,), device=device)
    inv = torch.ones((), device=device) / (t - 1)
    step = torch.arange(t - 1, dtype=torch.float32, device=device) * inv
    return torch.cat([step, torch.ones((1,), device=device)])


def synth_track_views(assets: SMPLAssets, draws: TrackDraws,
                      wh: int = cfg.PROXY_REP_INPUT_WH) -> dict:
    """A broadcast-clip track per player: T frames of one moving body.

    The pose interpolates linearly in axis-angle between two action poses,
    the yaw drifts linearly, the betas are fixed per player (what
    ``fit.track.track_fit`` shares), and the camera's scale and offset
    jitter per frame. All N·T crops are z-buffered in one pass.

    Returns ``silhouette (N, T, wh, wh), joints2d (N, T, 17, 2), body_pose
    (N, T, 23, 3, 3), global_orient (N, T, 1, 3, 3), betas (N, 10), cam_wp
    (N, T, 3)``, and ``image (N, T, wh, wh, 3)`` when the draws carry the
    appearance.
    """
    dev = assets.faces.device
    d = draws_to(draws, dev)
    n, t = d.scale_noise.shape
    scale = torch.as_tensor(_POSE_SCALE, device=dev)[None]
    aa0 = d.pose_noise[0] * scale * d.energy[0]
    aa1 = d.pose_noise[1] * scale * d.energy[1]
    lin = _linspace01(t, dev)
    frac = lin[None, :, None, None]
    body_aa = _knees_flex(aa0[:, None] * (1 - frac) + aa1[:, None] * frac)
    body_rm = batch_rodrigues(body_aa.reshape(-1, 3)).reshape(n, t, 23, 3, 3)
    yaw = d.yaw0[:, None] + (d.dyaw * 0.6)[:, None] * lin[None]
    orient = orient_for_view(d.orient, yaw.reshape(-1), 0.0) \
        .reshape(n, t, 1, 3, 3)
    betas = d.shape_noise * 1.5
    s = d.scale + d.scale_noise * 0.02
    cam_wp = torch.cat([s[..., None], d.txy * 0.06], dim=-1)   # (N, T, 3)
    flat = render_view(assets, body_rm.reshape(n * t, 23, 3, 3),
                       orient.reshape(n * t, 1, 3, 3),
                       betas.repeat_interleave(t, dim=0),
                       cam_wp.reshape(n * t, 3), wh=wh,
                       appearance=d.appearance)
    out = {"silhouette": flat["silhouette"].reshape(n, t, wh, wh),
           "joints2d": flat["joints2d"].reshape(n, t, 17, 2),
           "body_pose": body_rm, "global_orient": orient,
           "betas": betas, "cam_wp": cam_wp}
    if "image" in flat:
        out["image"] = flat["image"].reshape(n, t, wh, wh, 3)
    return out


# ---------------------------------------------------------------------------
# Tree writer (stage-driver-compatible layout)
# ---------------------------------------------------------------------------

def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _tree_views(data: dict):
    """The writer's (image root, proxy root, stem, view) per view, in the
    order of the corruption draws: the narrow views, then the broad."""
    out = [("images", "proxies", f"view{i}", v)
           for i, v in enumerate(data["views"])]
    if "broad" in data:
        out.append(("broad_images", "broad_proxies", "broad", data["broad"]))
    return out


def sample_tree_corruption(gen: torch.Generator, data: dict
                           ) -> Tuple[CorruptionDraws, ...]:
    """The corruption draws of one scene's written proxies: one batch of N
    players per view, narrow views first, then the broad one, from ``gen``
    in that order; no dropout (``drop_p=0``: the fits read raw
    coordinates)."""
    return tuple(sample_corruption_draws(
        gen, view["silhouette"].shape[0], view["silhouette"].shape[-1],
        drop_p=0.0) for _, _, _, view in _tree_views(data))


def _write_proxy(proxy_dir: str, stem: str, sil: np.ndarray,
                 j2d: np.ndarray) -> None:
    os.makedirs(proxy_dir, exist_ok=True)
    # uint8 keeps the tree ~4x smaller; the stages read it as float32.
    np.save(os.path.join(proxy_dir, stem + "_sil.npy"), sil.astype(np.uint8))
    io.write_joints2d(os.path.join(proxy_dir, stem + "_j2d.xml"), j2d)


def write_scene_tree(root: str, game: str, scene_name: str, data: dict,
                     corruption: Optional[Sequence[CorruptionDraws]] = None,
                     write_images: bool = True,
                     first_player_id: int = 2) -> None:
    """Write one scene (:func:`synth_scene_views`' dict, on any device) to
    the reference folder layout under ``root``:
    ``images|broad_images/<game>/<scene>/<player>/<stem>.png``, the proxies
    (``<stem>_sil.npy`` uint8, ``<stem>_j2d.xml`` (17, 3) with a score
    column) under ``proxies|broad_proxies``, the clean ground truth in
    ``gt/.../gt.npz`` and ``scenes/<game>/<scene>/{boxes,index,ball}.xml``.

    ``corruption`` (one :class:`CorruptionDraws` per view, in
    :func:`sample_tree_corruption`'s order) applies the STRAPS
    detector-noise model to the written proxies: joint jitter with noisy
    scores and silhouette cut-outs; None writes them clean, scores 1.
    Without ``write_images`` (or without images in the views) each view's
    image is a 1-px marker: the tree walker enumerates views by ``.png``.
    Player ids start at ``first_player_id`` because the single- and
    multi-view stages skip id '1' (the reference's camera-man crop).
    """
    scene = data["scene"]
    n = int(scene["betas"].shape[0])
    views = _tree_views(data)
    if corruption is not None and len(corruption) != len(views):
        raise ValueError("%d corruption draws for %d views"
                         % (len(corruption), len(views)))
    gt_views = {}
    for k, (img_root, proxy_root, stem, view) in enumerate(views):
        sil, j2d = view["silhouette"], view["joints2d"]
        if corruption is None:
            scores = torch.ones(j2d.shape[:2], dtype=j2d.dtype,
                                device=j2d.device)
        else:
            sil, j2d, scores = corrupt_proxy_inputs(
                draws_to(corruption[k], sil.device), sil, j2d,
                return_scores=True)
        sil_c = _np(sil)
        j2d_c = _np(torch.cat([j2d, scores[..., None]], dim=-1))
        gt_views[stem] = {name: _np(view[name]) for name in
                          ("global_orient", "cam_wp", "joints2d")}
        image = (_np(view["image"]) if write_images and "image" in view
                 else None)
        for p in range(n):
            pid = str(first_player_id + p)
            img_dir = os.path.join(root, img_root, game, scene_name, pid)
            os.makedirs(img_dir, exist_ok=True)
            io.write_png(os.path.join(img_dir, stem + ".png"),
                         np.zeros((1, 1, 3), np.uint8) if image is None
                         else (image[p] * 255).astype(np.uint8))
            _write_proxy(
                os.path.join(root, proxy_root, game, scene_name, pid),
                stem, sil_c[p], j2d_c[p])

    scene_np = {name: _np(v) for name, v in scene.items()}
    for p in range(n):
        pid = str(first_player_id + p)
        gt_dir = os.path.join(root, "gt", game, scene_name, pid)
        os.makedirs(gt_dir, exist_ok=True)
        np.savez(os.path.join(gt_dir, "gt.npz"),
                 body_pose=scene_np["body_pose"][p],
                 betas=scene_np["betas"][p],
                 yaw=scene_np["yaw"][p],
                 boxes=scene_np["boxes"][p],
                 **{f"{stem}_global_orient": gv["global_orient"][p]
                    for stem, gv in gt_views.items()},
                 **{f"{stem}_cam_wp": gv["cam_wp"][p]
                    for stem, gv in gt_views.items()},
                 **{f"{stem}_joints2d": gv["joints2d"][p]
                    for stem, gv in gt_views.items()})

    scene_dir = os.path.join(root, "scenes", game, scene_name)
    os.makedirs(scene_dir, exist_ok=True)
    io.write_boxes(os.path.join(scene_dir, "boxes.xml"), scene_np["boxes"])
    io.write_index(os.path.join(scene_dir, "index.xml"),
                   list(range(first_player_id, first_player_id + n)))
    io.write_json_xml(os.path.join(scene_dir, "ball.xml"),
                      [float(x) for x in scene_np["ball_xy"]])
