"""Synthetic SMPL crops and frames of ``train/synth.py``.

Counterpart of ``soccerplayershapepose_tpu/train/synth.py:synth_crop_batch``:
a random soccer body per crop, an occluding second body in front of or
behind it, both z-buffered at the crop resolution (the labelled player's
visible silhouette) and again at stride 4 (part ids and UV), the 17
KP-RCNN joints and their visibility. With ``with_image`` the full pass also
carries each vertex's shaded kit colour (team jersey, plain or striped,
shorts, socks, skin tone; Lambert-shaded from a random light), and the
bodies are composited over a procedural pitch background; with
``domain_rand`` the background has mowing stripes, field lines, a crowd
band or wild noise, and the image gets a directional motion blur and
photometric jitter, else it is plain green noise.

Randomness is explicit. A sampler draws everything random from a
``torch.Generator`` into a small NamedTuple (:func:`sample_crop_draws`), and
:func:`render_crop_batch` is a deterministic function of those draws, so a
test can feed it the draws of the JAX key stream. One coupling of that
stream is kept: the JAX function takes the sign of the occluder's depth
offset from ``bernoulli(keys[6], 0.5)`` and its magnitude from
``uniform(keys[6], 0.3, 1.2)``, one uniform draw for both, so a nearer
occluder moves by [0.3, 0.75) and a farther one by [0.75, 1.2);
:func:`occluder_depth_offset` derives both from one uniform too.

The appearance is drawn after the geometry, and only for images
(:func:`sample_appearance_draws`), so the geometry-only stream of a
generator is the same with or without images. Three more couplings of the
JAX key stream are kept the same way, each pair from one uniform: a kit's
stripe direction (``u < 0.5``: vertical) and phase (6.28·u); its white
shorts (``u < 0.5``) and jersey-coloured socks (``u < 0.6``), so white
shorts come with jersey socks; the mowing stripes' period (25 + 65·u) and
phase (6.28·u).

Frames (:func:`sample_frame_draws`, :func:`render_frame_batch`, the
counterpart of ``synth_frame_batch``) place N kit-coloured players in an
h × w frame by their own small cameras and z-buffer all of them in one
pass at max(h, w)², so they occlude each other; the detector's
evaluation and the full-frame pipeline take their images, boxes and
visible fills.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

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


# Kit groups over the 24 SMPL joints (part id = dominant LBS joint):
# 0 skin, 1 jersey, 2 shorts, 3 socks/boots.
_KIT_GROUP = np.zeros(24, np.int64)
_KIT_GROUP[[3, 6, 9, 13, 14, 16, 17, 18, 19]] = 1    # spine/collar/arm→elbow
_KIT_GROUP[[0, 1, 2]] = 2                            # pelvis + hips
_KIT_GROUP[[7, 8, 10, 11]] = 3                       # ankles + feet

_SKIN_TONES = np.array([
    [0.98, 0.84, 0.72], [0.92, 0.74, 0.60], [0.82, 0.62, 0.48],
    [0.66, 0.47, 0.34], [0.48, 0.32, 0.22], [0.35, 0.22, 0.15],
], np.float32)

BLUR_KSIZE = 9            # the motion blur's kernel side, px

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


class KitDraws(NamedTuple):
    """The random draws of ``_kit_vertex_colors`` for one batch of bodies."""
    skin_tone: torch.Tensor    # (B,) int64 index into _SKIN_TONES
    skin_gain: torch.Tensor    # (B, 1) U[0.85, 1.1)
    jersey1: torch.Tensor      # (B, 3) U[0.05, 1): first jersey colour
    jersey2: torch.Tensor      # (B, 3) U[0.05, 1): the stripes' other one
    striped: torch.Tensor      # (B, 1) {0, 1} float: 0 is a plain kit
    freq: torch.Tensor         # (B, 1) U[8, 26): stripe frequency
    stripe_u: torch.Tensor     # (B, 1) U[0, 1): direction and phase
    own_shorts: torch.Tensor   # (B, 1) bool: shorts in a colour of their own
    shorts_rgb: torch.Tensor   # (B, 3) U[0.05, 1): that colour
    shorts_socks_u: torch.Tensor  # (B, 1) U[0, 1): white shorts, jersey socks


class ShadingDraws(NamedTuple):
    light: torch.Tensor        # (B, 3) standard normal: light direction
    ambient: torch.Tensor      # (B, 1, 1) U[0.45, 0.75)


class BackgroundDraws(NamedTuple):
    """The random draws of ``_background`` (the domain-randomised pitch)."""
    base: torch.Tensor         # (B, 1, 1, 3) U[-0.08, 0.10): grass jitter
    theta: torch.Tensor        # (B, 1, 1) U[0, 3.14): mowing direction
    mow_u: torch.Tensor        # (B, 1, 1) U[0, 1): mowing period and phase
    line_alpha: torch.Tensor   # (2, B, 1, 1) U[0, 3.14): field lines
    line_c: torch.Tensor       # (2, B, 1, 1) U[0, 1): offset / max(h, w)
    line_width: torch.Tensor   # (2, B, 1, 1) U[1, 3)
    line_on: torch.Tensor      # (2, B, 1, 1) {0, 1} float, p 0.6
    crowd_on: torch.Tensor     # (B, 1, 1) {0, 1} float, p 0.35
    crowd_frac: torch.Tensor   # (B, 1, 1) U[0.10, 0.35): crowd band height
    crowd: torch.Tensor        # (B, h/4, w/4, 3) U[0.05, 0.85)
    wild: torch.Tensor         # (B, 1, 1, 1) {0, 1} float, p 0.08
    wild_bg: torch.Tensor      # (B, h/4, w/4, 3) U[0, 1)
    noise: torch.Tensor        # (B, h, w, 3) U[-0.05, 0.05)


class PlainBackgroundDraws(NamedTuple):
    """The background without domain randomisation: green noise."""
    base: torch.Tensor         # (B, 1, 1, 3) U[-0.08, 0.08)
    noise: torch.Tensor        # (B, h, w, 3) U[-0.06, 0.06)


class BlurDraws(NamedTuple):
    theta: torch.Tensor        # (B,) U[0, 3.14): blur direction
    length: torch.Tensor       # (B,) U[1, 9): blur length, px
    apply: torch.Tensor        # (B, 1, 1, 1) {0, 1} float, p 0.35


class PhotometricDraws(NamedTuple):
    bright: torch.Tensor       # (B, 1, 1, 1) U[-0.1, 0.1)
    contrast: torch.Tensor     # (B, 1, 1, 1) U[0.8, 1.2)
    gains: torch.Tensor        # (B, 1, 1, 3) U[0.92, 1.08)
    noise: torch.Tensor        # (B, h, w, 3) standard normal
    noise_scale: torch.Tensor  # (B, 1, 1, 1) U[0, 0.03)


class AppearanceDraws(NamedTuple):
    """Everything random about a batch's RGB images. The occluder's draws
    are None without an occluder; blur and photometric jitter are None
    without domain randomisation."""
    kit: KitDraws
    shading: ShadingDraws
    occluder_kit: Optional[KitDraws]
    occluder_shading: Optional[ShadingDraws]
    background: Union[BackgroundDraws, PlainBackgroundDraws]
    blur: Optional[BlurDraws]
    photometric: Optional[PhotometricDraws]


class CropDraws(NamedTuple):
    body: BodyDraws
    occluder: Optional[OccluderDraws]          # None: no occluding body
    appearance: Optional[AppearanceDraws] = None   # None: labels only


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


def _bernoulli(gen, shape, p):
    return (_uniform(gen, shape, 0.0, 1.0) < p).to(torch.float32)


def sample_crop_draws(gen: torch.Generator, b: int,
                      image_wh: Optional[int] = None,
                      domain_rand: bool = True, occluders: bool = True,
                      image_gen: Optional[torch.Generator] = None
                      ) -> CropDraws:
    """Everything random about one batch of crops: the geometry from
    ``gen``, on its device; with ``image_wh`` also the appearance of
    image_wh² RGB crops, after the geometry, from ``image_gen`` (default
    ``gen``), on its device."""
    body = sample_body_draws(gen, b)
    occ = None
    if occluders:
        occ = OccluderDraws(
            body=sample_body_draws(gen, b),
            side=torch.where(_uniform(gen, (b,), 0.0, 1.0) < 0.5, 1.0, -1.0),
            offset=_uniform(gen, (b,), 0.35, 0.8),
            dz_u=_uniform(gen, (b,), 0.0, 1.0),
            present=_bernoulli(gen, (b, 1), 0.45))
    appearance = None
    if image_wh is not None:
        appearance = sample_appearance_draws(
            gen if image_gen is None else image_gen, b, image_wh,
            domain_rand, occluders)
    return CropDraws(body, occ, appearance)


def sample_kit_draws(gen: torch.Generator, b: int) -> KitDraws:
    def randint(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=gen.device)

    return KitDraws(
        skin_tone=randint(len(_SKIN_TONES), (b,)),
        skin_gain=_uniform(gen, (b, 1), 0.85, 1.1),
        jersey1=_uniform(gen, (b, 3), 0.05, 1.0),
        jersey2=_uniform(gen, (b, 3), 0.05, 1.0),
        striped=randint(2, (b, 1)).to(torch.float32),
        freq=_uniform(gen, (b, 1), 8.0, 26.0),
        stripe_u=_uniform(gen, (b, 1), 0.0, 1.0),
        own_shorts=_uniform(gen, (b, 1), 0.0, 1.0) < 0.5,
        shorts_rgb=_uniform(gen, (b, 3), 0.05, 1.0),
        shorts_socks_u=_uniform(gen, (b, 1), 0.0, 1.0))


def sample_shading_draws(gen: torch.Generator, b: int) -> ShadingDraws:
    return ShadingDraws(light=_normal(gen, (b, 3)),
                        ambient=_uniform(gen, (b, 1, 1), 0.45, 0.75))


def sample_appearance_draws(gen: torch.Generator, b: int, wh: int,
                            domain_rand: bool = True,
                            occluders: bool = True) -> AppearanceDraws:
    """The appearance of a batch of wh² RGB crops, on the generator's
    device (the per-pixel noise is (B, wh, wh, 3) twice over)."""
    kit, shading = sample_kit_draws(gen, b), sample_shading_draws(gen, b)
    o_kit = o_shading = None
    if occluders:
        o_kit, o_shading = sample_kit_draws(gen, b), \
            sample_shading_draws(gen, b)
    if not domain_rand:
        return AppearanceDraws(
            kit, shading, o_kit, o_shading, PlainBackgroundDraws(
                base=_uniform(gen, (b, 1, 1, 3), -0.08, 0.08),
                noise=_uniform(gen, (b, wh, wh, 3), -0.06, 0.06)),
            None, None)
    bg = sample_background_draws(gen, b, wh, wh)
    blur = sample_blur_draws(gen, b)
    return AppearanceDraws(kit, shading, o_kit, o_shading, bg, blur,
                           sample_photometric_draws(gen, b, wh, wh))


def sample_background_draws(gen: torch.Generator, b: int, h: int,
                            w: int) -> BackgroundDraws:
    """The draws of a batch of h × w domain-randomised pitches."""
    hc, wc = max(h // 4, 1), max(w // 4, 1)
    return BackgroundDraws(
        base=_uniform(gen, (b, 1, 1, 3), -0.08, 0.10),
        theta=_uniform(gen, (b, 1, 1), 0.0, 3.14),
        mow_u=_uniform(gen, (b, 1, 1), 0.0, 1.0),
        line_alpha=_uniform(gen, (2, b, 1, 1), 0.0, 3.14),
        line_c=_uniform(gen, (2, b, 1, 1), 0.0, 1.0),
        line_width=_uniform(gen, (2, b, 1, 1), 1.0, 3.0),
        line_on=_bernoulli(gen, (2, b, 1, 1), 0.6),
        crowd_on=_bernoulli(gen, (b, 1, 1), 0.35),
        crowd_frac=_uniform(gen, (b, 1, 1), 0.10, 0.35),
        crowd=_uniform(gen, (b, hc, wc, 3), 0.05, 0.85),
        wild=_bernoulli(gen, (b, 1, 1, 1), 0.08),
        wild_bg=_uniform(gen, (b, hc, wc, 3), 0.0, 1.0),
        noise=_uniform(gen, (b, h, w, 3), -0.05, 0.05))


def sample_blur_draws(gen: torch.Generator, b: int) -> BlurDraws:
    return BlurDraws(theta=_uniform(gen, (b,), 0.0, 3.14),
                     length=_uniform(gen, (b,), 1.0, float(BLUR_KSIZE)),
                     apply=_bernoulli(gen, (b, 1, 1, 1), 0.35))


def sample_photometric_draws(gen: torch.Generator, b: int, h: int,
                             w: int) -> PhotometricDraws:
    return PhotometricDraws(
        bright=_uniform(gen, (b, 1, 1, 1), -0.10, 0.10),
        contrast=_uniform(gen, (b, 1, 1, 1), 0.8, 1.2),
        gains=_uniform(gen, (b, 1, 1, 3), 0.92, 1.08),
        noise=_normal(gen, (b, h, w, 3)),
        noise_scale=_uniform(gen, (b, 1, 1, 1), 0.0, 0.03))


def draws_to(draws, device: torch.device):
    """A draws tuple (nested NamedTuples of tensors, None for what was not
    drawn) on ``device``."""
    if draws is None:
        return None
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


def _scaled(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """A U[0, 1) draw → U[lo, hi) with the fp32 steps of
    ``jax.random.uniform(key, minval=lo, maxval=hi)``."""
    lo, hi = np.float32(lo), np.float32(hi)
    return torch.clamp(u * float(hi - lo) + float(lo), min=float(lo))


_TWO_PI = float(np.float32(6.28))   # the JAX package's 2π


# ---------------------------------------------------------------------------
# Appearance
# ---------------------------------------------------------------------------

def _kit_vertex_colors(assets: SMPLAssets, d: KitDraws) -> torch.Tensor:
    """(B, V, 3) kit colours: skin, the jersey (plain, or striped along the
    template's x or y), shorts and socks by each vertex's kit group."""
    dev = d.jersey1.device
    group = torch.as_tensor(_KIT_GROUP, device=dev)[
        vertex_parts(assets).to(torch.long)][None, :, None]   # (1, V, 1)
    uvt = vertex_uv(assets)                                   # (V, 2)
    skin = torch.as_tensor(_SKIN_TONES, device=dev)[d.skin_tone] \
        * d.skin_gain                                         # (B, 3)
    freq = d.striped * d.freq
    vertical = d.stripe_u < 0.5
    phase = _scaled(d.stripe_u, 0.0, 6.28)
    shorts = torch.where(d.own_shorts, d.shorts_rgb,
                         torch.where(d.shorts_socks_u < 0.5, 0.92, 0.08))
    socks = torch.where(d.shorts_socks_u < 0.6, d.jersey1, 0.9)
    coord = torch.where(vertical, uvt[None, :, 0], uvt[None, :, 1])  # (B, V)
    stripe = torch.sin(freq * coord * _TWO_PI + phase) > 0.0
    jersey = torch.where(stripe[..., None], d.jersey1[:, None],
                         d.jersey2[:, None])                  # (B, V, 3)
    return torch.where(group == 0, skin[:, None], torch.where(
        group == 1, jersey, torch.where(group == 2, shorts[:, None],
                                        socks[:, None])))


def _vertex_faces(faces: torch.Tensor, n_verts: int) -> torch.Tensor:
    """(V, K) ids of each vertex's faces, as the corners list them (corner
    0 of every face, then corner 1, then 2), padded with the id F."""
    n_faces = faces.shape[0]
    corner = faces.t().reshape(-1).to(torch.long)             # (3F,)
    order = torch.argsort(corner, stable=True)
    counts = torch.bincount(corner, minlength=n_verts)
    start = torch.cumsum(counts, 0) - counts
    slot = torch.arange(order.numel(), device=faces.device) \
        - start[corner[order]]
    idx = torch.full((n_verts, int(counts.max())), n_faces,
                     dtype=torch.long, device=faces.device)
    idx[corner[order], slot] = order % n_faces
    return idx


def _vertex_normals(vertices: torch.Tensor,
                    faces: torch.Tensor) -> torch.Tensor:
    """(B, V, 3) area-weighted vertex normals of the posed mesh. Each
    vertex sums its faces' normals by a gather and a sum in one fixed
    order, so the card gives the same bits on every run (``index_add_``
    adds with atomics there)."""
    f = faces.to(torch.long)
    v0, v1, v2 = (vertices[:, f[:, k]] for k in range(3))
    fn = torch.cross(v1 - v0, v2 - v0, dim=-1)                # (B, F, 3)
    fn = torch.cat([fn, torch.zeros_like(fn[:, :1])], dim=1)  # + padding
    vn = fn[:, _vertex_faces(f, vertices.shape[1])].sum(dim=2)
    return vn / torch.clamp(torch.linalg.vector_norm(vn, dim=-1,
                                                     keepdim=True), min=1e-8)


def _shaded_colors(d: ShadingDraws, vertices: torch.Tensor,
                   faces: torch.Tensor, colors: torch.Tensor) -> torch.Tensor:
    """Lambert shading from a directional light (biased to come from
    above, −y) plus ambient light."""
    light = d.light.clone()
    light[:, 1] += -1.0
    light = light / torch.clamp(torch.linalg.vector_norm(
        light, dim=-1, keepdim=True), min=1e-8)
    vn = _vertex_normals(vertices, faces)
    lambert = torch.clamp(torch.einsum("bvk,bk->bv", vn, light),
                          min=0.0)[..., None]
    return torch.clamp(colors * (d.ambient + (1.0 - d.ambient) * lambert),
                       0.0, 1.0)


def _upsample4(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, h/4, w/4, C) → (B, h, w, C), each cell repeated 4 × 4."""
    return x.repeat_interleave(4, 1).repeat_interleave(4, 2)[:, :h, :w]


def _background(d: BackgroundDraws, h: int, w: int) -> torch.Tensor:
    """(B, h, w, 3) procedural pitch: jittered grass, mowing stripes, up to
    two white field lines, a crowd band at the top, sometimes pure noise,
    plus pixel noise."""
    dev = d.base.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    base = torch.tensor([0.16, 0.42, 0.20], device=dev) + d.base
    period = _scaled(d.mow_u, 25.0, 90.0)
    phase = _scaled(d.mow_u, 0.0, 6.28)
    proj = xs * torch.cos(d.theta) + ys * torch.sin(d.theta)
    mow = 1.0 + 0.05 * torch.sign(torch.sin(proj * _TWO_PI / period + phase))
    bg = base * mow[..., None]
    for i in range(2):
        alpha = d.line_alpha[i]
        c = d.line_c[i] * float(max(h, w))
        dist = torch.abs(xs * torch.cos(alpha) + ys * torch.sin(alpha) - c)
        m = (torch.exp(-(dist / d.line_width[i]) ** 2) * 0.85
             * d.line_on[i])[..., None]
        bg = bg * (1 - m) + 0.93 * m
    edge = torch.clamp((d.crowd_on * d.crowd_frac * h - ys) / 6.0,
                       0.0, 1.0)[..., None]
    bg = bg * (1 - edge) + _upsample4(d.crowd, h, w) * edge
    bg = bg * (1 - d.wild) + _upsample4(d.wild_bg, h, w) * d.wild
    return torch.clamp(bg + d.noise, 0.0, 1.0)


def _plain_background(d: PlainBackgroundDraws) -> torch.Tensor:
    """(B, h, w, 3) green noise: the background without domain
    randomisation."""
    green = torch.tensor([0.18, 0.42, 0.22], device=d.base.device)
    return torch.clamp(green + d.base + d.noise, 0.0, 1.0)


def _motion_blur(d: BlurDraws, image: torch.Tensor) -> torch.Tensor:
    """Directional motion blur of (B, h, w, 3) images, applied where
    ``d.apply``: a per-sample 9×9 line kernel (a Gaussian profile of σ 0.6
    px across the line, the line's length along it), normalised, as one
    depthwise cross-correlation over the (1, 3B, h, w) view with zero
    padding."""
    b, h, w, _ = image.shape
    k = BLUR_KSIZE
    t = torch.arange(k, dtype=torch.float32, device=image.device) \
        - (k - 1) / 2.0
    ii, jj = t[:, None], t[None, :]
    cos_t = torch.cos(d.theta)[:, None, None]
    sin_t = torch.sin(d.theta)[:, None, None]
    along = jj * cos_t + ii * sin_t
    perp = -jj * sin_t + ii * cos_t
    kern = torch.exp(-(perp / 0.6) ** 2) \
        * (torch.abs(along) <= d.length[:, None, None] / 2.0)
    kern = kern / torch.clamp(kern.sum(dim=(1, 2), keepdim=True), min=1e-8)
    x = image.permute(0, 3, 1, 2).reshape(1, 3 * b, h, w)
    weight = kern.repeat_interleave(3, 0)[:, None]            # (3B, 1, k, k)
    blurred = F.conv2d(x, weight, padding=k // 2, groups=3 * b)
    blurred = blurred.reshape(b, 3, h, w).permute(0, 2, 3, 1)
    return image * (1 - d.apply) + blurred * d.apply


def _photometric(d: PhotometricDraws, image: torch.Tensor) -> torch.Tensor:
    """Brightness, contrast, per-channel gain and sensor noise."""
    noise = d.noise * d.noise_scale
    return torch.clamp(((image - 0.5) * d.contrast + 0.5 + d.bright)
                       * d.gains + noise, 0.0, 1.0)


def scene_colors(assets: SMPLAssets, scene: dict,
                 d: AppearanceDraws) -> torch.Tensor:
    """(B, n·V, 3) shaded kit colours of a crop scene's bodies, in the
    scene's vertex order (the player, then the occluder)."""
    colors = [_shaded_colors(d.shading, scene["body_vertices"], assets.faces,
                             _kit_vertex_colors(assets, d.kit))]
    if scene["occluder_vertices"] is not None:
        colors.append(_shaded_colors(
            d.occluder_shading, scene["occluder_vertices"], assets.faces,
            _kit_vertex_colors(assets, d.occluder_kit)))
    return torch.cat(colors, dim=1)


def compose_image(body_rgb: torch.Tensor, any_body: torch.Tensor,
                  d: AppearanceDraws) -> torch.Tensor:
    """(B, h, w, 3) image in [0, 1]: the rendered bodies over the
    background, then blur and photometric jitter under domain
    randomisation."""
    _, h, w, _ = body_rgb.shape
    if isinstance(d.background, BackgroundDraws):
        bg = _background(d.background, h, w)
    else:
        bg = _plain_background(d.background)
    a = any_body[..., None]
    image = body_rgb * a + bg * (1 - a)
    if d.blur is not None:
        image = _photometric(d.photometric, _motion_blur(d.blur, image))
    return image


# ---------------------------------------------------------------------------
# Crop batches
# ---------------------------------------------------------------------------

def render_crop_batch(assets: SMPLAssets, draws: CropDraws, wh: int = 256,
                      return_params: bool = False,
                      with_image: bool = False) -> dict:
    """One batch of crops from its draws, on the assets' device.

    Returns ``silhouette (B, wh, wh)`` {0, 1}, the labelled player's visible
    region; ``joints2d (B, 17, 2)`` px; ``kp_visible (B, 17)`` {0, 1}, in
    the crop and on a player pixel; ``part (B, wh/4, wh/4)`` int32 0..24;
    ``uv (B, wh/4, wh/4, 2)``; with ``with_image`` the RGB ``image
    (B, wh, wh, 3)`` in [0, 1] (the draws must carry a wh² appearance,
    whose draws say whether it is domain-randomised); with
    ``return_params`` also the
    generating ``body_pose``, ``global_orient``, ``betas`` and ``cam_wp``.
    """
    if wh % STRIDE:
        raise ValueError(f"wh must be a multiple of {STRIDE}, got {wh}")
    draws = draws_to(draws, assets.faces.device)
    scene = crop_scene(assets, draws, wh)
    colors = None
    if with_image:
        d = draws.appearance
        if d is None or tuple(d.background.noise.shape[1:3]) != (wh, wh):
            raise ValueError("with_image needs the appearance draws of "
                             "%d^2 crops" % wh)
        colors = scene_colors(assets, scene, d)
    batch = crop_labels(assets, scene["verts2d"], scene["verts_z"],
                        scene["faces"], scene["is_player"],
                        scene["joints2d"], wh, colors=colors)
    if with_image:
        batch["image"] = compose_image(batch.pop("body_rgb"),
                                       batch.pop("any_body"),
                                       draws.appearance)
    if return_params:
        batch.update({k: scene[k] for k in ("body_pose", "global_orient",
                                            "betas", "cam_wp")})
    return batch


def crop_scene(assets: SMPLAssets, draws: CropDraws, wh: int) -> dict:
    """The geometry of a crop batch: the player and the occluder posed and
    projected into the wh² crop. Returns ``verts2d (B, 2V, 2)``,
    ``verts_z (B, 2V)``, ``faces (2F, 3)``, ``is_player (B, 2V, 1)`` (the
    player's vertices first), the player's ``joints2d (B, 17, 2)`` and its
    parameters, and each body's posed ``body_vertices`` and
    ``occluder_vertices`` (B, V, 3). Without occluder draws the scene holds
    the player alone (V vertices, F faces; ``occluder_vertices`` None).
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
    params = {"joints2d": joints2d, "body_pose": body_rm,
              "global_orient": orient_rm, "betas": betas, "cam_wp": cam_wp,
              "body_vertices": out.vertices}
    occ = draws.occluder
    if occ is None:
        return {"verts2d": verts2d, "verts_z": verts_z, "faces": assets.faces,
                "is_player": torch.ones((b, verts2d.shape[1], 1), device=dev),
                "occluder_vertices": None, **params}
    # The occluder: its own body, beside the player towards a crop edge, in
    # front of or behind it (the z-buffer decides what is visible).
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
            "occluder_vertices": o_out.vertices, **params}


def pass_attributes(assets: SMPLAssets, is_player: torch.Tensor,
                    colors: Optional[torch.Tensor] = None):
    """The per-vertex attributes of the two z-buffer passes over a scene of
    n bodies (``is_player`` (B, n·V, 1)): the full-resolution pass's
    (B, n·V, 4) [colour ×3, ownership] (zero colour without ``colors``,
    keeping the JAX package's layout) and the stride-4 pass's (B, n·V, 27)
    [part one-hot ×24, UV ×2, ownership]."""
    b, nv, _ = is_player.shape
    n_bodies = nv // assets.v_template.shape[0]
    if colors is None:
        colors = torch.zeros((b, nv, 3), device=is_player.device)
    full = torch.cat([colors, is_player], dim=-1)
    small = torch.cat([
        F.one_hot(vertex_parts(assets).to(torch.long), NUM_PARTS).to(
            torch.float32), vertex_uv(assets)], dim=-1)       # (V, 26)
    small = torch.cat([small.repeat(n_bodies, 1)[None].expand(b, -1, -1),
                       is_player], dim=-1)
    return full, small


def crop_labels(assets: SMPLAssets, verts2d: torch.Tensor,
                verts_z: torch.Tensor, faces: torch.Tensor,
                is_player: torch.Tensor, joints2d: torch.Tensor,
                wh: int, colors: Optional[torch.Tensor] = None) -> dict:
    """The labels of a crop scene: two z-buffered passes (K3 on the card)
    and the joint visibility; see :func:`render_crop_batch`. With
    ``colors`` (B, n·V, 3) the full pass carries them too, and the result
    adds the rendered ``body_rgb (B, wh, wh, 3)`` and the coverage of any
    body ``any_body (B, wh, wh)`` {0, 1}."""
    b = verts2d.shape[0]
    dev = verts2d.device
    full_attrs, attr_small = pass_attributes(assets, is_player, colors)
    full, full_mask = rasterize_attributes(verts2d, verts_z, full_attrs,
                                           faces, wh)
    sil = (full_mask & (full[..., 3] > 0.5)).to(torch.float32)
    rgb = {} if colors is None else {
        "body_rgb": full[..., :3], "any_body": full_mask.to(torch.float32)}

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
            "part": part, "uv": uv, **rgb}


# ---------------------------------------------------------------------------
# Frame batches (detector training and evaluation, the full-frame pipeline)
# ---------------------------------------------------------------------------

class FrameDraws(NamedTuple):
    """Everything random about a batch of B frames of N players each: the
    B·N bodies (their own ``cam_wp`` unused), each player's camera, which
    players are in the frame, and the appearance (kit and shading per
    player; pitch, blur and jitter per h × w frame; no occluder)."""
    body: BodyDraws
    cam_wp: torch.Tensor       # (B·N, 3) s, tx, ty
    valid: torch.Tensor        # (B, N) {0, 1} float, p 0.8
    appearance: AppearanceDraws


def sample_frame_draws(gen: torch.Generator, b: int, n_players: int,
                       hw: Tuple[int, int],
                       image_gen: Optional[torch.Generator] = None
                       ) -> FrameDraws:
    """The draws of B h × w frames: the geometry from ``gen``, then the
    appearance from ``image_gen`` (default ``gen``), each on its
    generator's device."""
    h, w = hw
    bn = b * n_players
    body = sample_body_draws(gen, bn)
    cam = torch.stack([_uniform(gen, (bn,), 0.08, 0.28),
                       _uniform(gen, (bn,), -0.85, 0.85),
                       _uniform(gen, (bn,), -0.75, 0.75)], dim=-1)
    valid = _bernoulli(gen, (b, n_players), 0.8)
    ig = gen if image_gen is None else image_gen
    appearance = AppearanceDraws(
        kit=sample_kit_draws(ig, bn), shading=sample_shading_draws(ig, bn),
        occluder_kit=None, occluder_shading=None,
        background=sample_background_draws(ig, b, h, w),
        blur=sample_blur_draws(ig, b),
        photometric=sample_photometric_draws(ig, b, h, w))
    return FrameDraws(body, cam, valid, appearance)


def frame_scene(assets: SMPLAssets, draws: FrameDraws, hw: Tuple[int, int]
                ) -> dict:
    """The geometry and attributes of a batch of frames: each player posed
    and projected by its own weak-perspective camera into the max(h, w)
    square, the square centred on the frame, a dropped player (``valid``
    0) moved +1e5 px off it. Returns ``verts2d (B, N·V, 2)``, ``verts_z
    (B, N·V)``, ``faces (N·F, 3)``, ``attrs (B, N·V, 4)`` (the shaded kit
    colour and the player id 1..N, which all three vertices of a face
    share), ``boxes (B, N, 4)`` pixel [x1, y1, x2, y2] of each player's
    vertices and ``wh`` = max(h, w)."""
    h, w = hw
    wh = max(h, w)
    dev = assets.faces.device
    draws = draws_to(draws, dev)
    b, n = draws.valid.shape
    body_rm, orient_rm, betas, _ = smpl_params_from_draws(draws.body)
    out = smpl_forward(assets, betas, body_rm, orient_rm)
    transl = weak_perspective_to_translation(draws.cam_wp, cfg.FOCAL_LENGTH,
                                             wh)
    verts2d = perspective_project(out.vertices, None, transl,
                                  focal_length=cfg.FOCAL_LENGTH, img_wh=wh)
    verts_z = out.vertices[..., 2] + transl[:, None, 2]
    verts2d = verts2d + torch.tensor([(w - wh) / 2.0, (h - wh) / 2.0],
                                     device=dev)
    valid = draws.valid.reshape(b * n)
    verts2d = verts2d + (1.0 - valid)[:, None, None] * 1e5
    boxes = torch.cat([torch.amin(verts2d, dim=1),
                       torch.amax(verts2d, dim=1)], dim=-1)   # (B·N, 4)

    d = draws.appearance
    colors = _shaded_colors(d.shading, out.vertices, assets.faces,
                            _kit_vertex_colors(assets, d.kit))
    v = assets.v_template.shape[0]
    n_faces = assets.faces.shape[0]
    ids = torch.arange(1, n + 1, dtype=torch.float32,
                       device=dev).repeat_interleave(v)
    attrs = torch.cat([colors.reshape(b, n * v, 3),
                       ids[None, :, None].expand(b, -1, -1)], dim=-1)
    faces = (assets.faces.repeat(n, 1)
             + (torch.arange(n, device=dev).repeat_interleave(n_faces)
                * v).to(assets.faces.dtype)[:, None])
    return {"verts2d": verts2d.reshape(b, n * v, 2),
            "verts_z": verts_z.reshape(b, n * v), "faces": faces,
            "attrs": attrs, "boxes": boxes.reshape(b, n, 4), "wh": wh}


def render_frame_batch(assets: SMPLAssets, draws: FrameDraws,
                       hw: Tuple[int, int]) -> dict:
    """Multi-player frames from their draws, on the assets' device.

    All the players of a frame (:func:`frame_scene`) are z-buffered in one
    pass at max(h, w)² (K3 on the card), so they occlude each other; the
    player id rides along as a fourth attribute and names the winner of
    each pixel. The square is cut to h × w and composited over the pitch,
    then blurred and jittered.

    Returns ``image (B, h, w, 3)`` in [0, 1]; ``boxes (B, N, 4)`` pixel
    [x1, y1, x2, y2] of each player's vertices; ``mask (B, N)`` validity;
    ``visible_fill (B, N)``, the player's visible (z-buffer-winning) pixels
    over its box's area (a fully visible player fills ~0.35-0.45).
    """
    h, w = hw
    draws = draws_to(draws, assets.faces.device)
    scene = frame_scene(assets, draws, hw)
    attrs, mask = rasterize_attributes(scene["verts2d"], scene["verts_z"],
                                       scene["attrs"], scene["faces"],
                                       scene["wh"])
    any_sil = mask[:, :h, :w].to(torch.float32)
    id_map = torch.round(attrs[:, :h, :w, 3]) * any_sil       # (B, h, w)
    boxes = scene["boxes"]
    player = torch.arange(1, boxes.shape[1] + 1, dtype=torch.float32,
                          device=boxes.device)
    vis_px = (id_map[..., None] == player).sum(dim=(1, 2)).to(torch.float32)
    area = torch.clamp((boxes[..., 2] - boxes[..., 0])
                       * (boxes[..., 3] - boxes[..., 1]), min=1.0)
    image = compose_image(attrs[:, :h, :w, :3], any_sil, draws.appearance)
    return {"image": image, "boxes": boxes, "mask": draws.valid,
            "visible_fill": vis_px / area}


def synth_frame_batch(assets: SMPLAssets, gen: torch.Generator, b: int = 2,
                      n_players: int = 6, hw: Tuple[int, int] = (256, 256),
                      image_gen: Optional[torch.Generator] = None) -> dict:
    """:func:`render_frame_batch` of :func:`sample_frame_draws`."""
    return render_frame_batch(
        assets, sample_frame_draws(gen, b, n_players, hw, image_gen), hw)
