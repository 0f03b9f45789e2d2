"""Held-out evaluation of the inter-player pose relation module.

Counterpart of the inference half of
``soccerplayershapepose_tpu/train/relation.py``: noisy-scene tuples from
the scene factory (``train/scenes.py``: a shared team-action pose,
ball-facing orientations, broadcast-frame boxes), each player's ground-truth
rotmats perturbed per joint (a per-scene noise level plus heavy-tailed
outlier joints), a random number of real players per scene (the rest
padded), and the module's denoising measured before and after: rotmat MSE,
the mean per-joint geodesic angle and MPJPE through SMPL.

Randomness is explicit, as in ``train/scenes.py``: a sampler draws into
:class:`RelationDraws` and :func:`synth_relation_batch` is deterministic in
those draws. The trainer waits for the training core.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.models.relation import PoseRelationModule
from soccerplayershapepose_torch.ops.rotations import batch_rodrigues
from soccerplayershapepose_torch.pipeline.predict import on_device
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.smpl.model import smpl_forward
from soccerplayershapepose_torch.train.scenes import (
    OrientDraws, SceneDraws, orient_for_view, sample_orient_draws,
    sample_scene_draws, synth_scene_params)
from soccerplayershapepose_torch.train.synth import (
    _normal, _uniform, draws_to)
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, default_device)

# The v1 variant: 16 units of width 64 in a 1024-wide lifted space, a
# 64-wide box embedding.
V1_KWARGS = {"lift_dim": 1024, "n_relations": 16, "key_dim": 64,
             "geo_dim": 64}
NOISE_LO, NOISE_HI = 0.05, 0.35   # per-scene noise σ, rad per axis
OUTLIER_P = 0.06                  # per-joint probability of an outlier
OUTLIER_SCALE = 1.0               # σ of an outlier joint's extra rotation
EVAL_SEED = 50_000_000


class RelationDraws(NamedTuple):
    """The random draws of one batch of B scenes of N players."""
    scenes: Tuple[SceneDraws, ...]   # B scenes of N players
    azimuth: torch.Tensor            # (B,) U[-π, π): each scene's camera
    orient: OrientDraws              # (B·N, ·) upright noise
    sigma: torch.Tensor              # (B, 1, 1, 1) U[NOISE_LO, NOISE_HI)
    eps: torch.Tensor                # (B, N, 24, 3) standard normal
    outlier: torch.Tensor            # (B, N, 24, 1) bool
    outlier_eps: torch.Tensor        # (B, N, 24, 3) standard normal
    n_real: torch.Tensor             # (B,) int64 in [2, N]


def sample_relation_draws(gen: torch.Generator, b: int = 8,
                          n_players: int = 6) -> RelationDraws:
    n, j = n_players, cfg.NUM_JOINTS
    scenes = tuple(sample_scene_draws(gen, n) for _ in range(b))
    return RelationDraws(
        scenes=scenes,
        azimuth=_uniform(gen, (b,), -np.pi, np.pi),
        orient=sample_orient_draws(gen, b * n),
        sigma=_uniform(gen, (b, 1, 1, 1), NOISE_LO, NOISE_HI),
        eps=_normal(gen, (b, n, j, 3)),
        outlier=_uniform(gen, (b, n, j, 1), 0.0, 1.0) < OUTLIER_P,
        outlier_eps=_normal(gen, (b, n, j, 3)),
        n_real=torch.randint(2, n + 1, (b,), generator=gen,
                             device=gen.device))


def synth_relation_batch(draws: RelationDraws,
                         device: Optional[torch.device] = None) -> dict:
    """One batch of noisy scenes from its draws, on ``device`` (default
    the draws'): ``rotmats_noisy (B, N, 24, 3, 3)``, ``rotmats_gt``,
    ``boxes (B, N, 4)`` in 1920 × 1080 frame pixels, ``mask (B, N)``
    bool. The noise is right-multiplied: ``R_gt · R(σ·ε + outlier·ε'·
    OUTLIER_SCALE)`` per joint."""
    if device is not None:
        draws = draws_to(draws, torch.device(device))
    scenes = [synth_scene_params(d) for d in draws.scenes]
    b, n = draws.eps.shape[:2]
    j = cfg.NUM_JOINTS
    yaw = torch.stack([s["yaw"] for s in scenes])             # (B, N)
    orient = orient_for_view(
        draws.orient, yaw.reshape(-1),
        draws.azimuth[:, None].expand(b, n).reshape(-1)).reshape(
            b, n, 1, 3, 3)
    body = torch.stack([s["body_pose"] for s in scenes])      # (B, N, 23..)
    gt = torch.cat([orient, body], dim=2)
    eps = draws.eps * draws.sigma \
        + draws.outlier.to(torch.float32) * draws.outlier_eps * OUTLIER_SCALE
    noise_rm = batch_rodrigues(eps.reshape(-1, 3)).reshape(b, n, j, 3, 3)
    noisy = torch.einsum("bnjik,bnjkl->bnjil", gt, noise_rm)
    mask = torch.arange(n, device=gt.device)[None] < draws.n_real[:, None]
    return {"rotmats_noisy": noisy, "rotmats_gt": gt,
            "boxes": torch.stack([s["boxes"] for s in scenes]),
            "mask": mask}


def relation_metrics(assets: SMPLAssets, batch: dict,
                     refined: torch.Tensor) -> dict:
    """Before (``_in``) and after (``_out``) the module, over the real
    players: rotmat MSE over the 216 entries, the mean per-joint geodesic
    angle in degrees (from the trace of R_gtᵀ·R, clipped; the refined
    rotmats are a residual sum, not projected), and MPJPE in mm over the
    COCO joints (SMPL with zero betas). Values are 0-dim tensors."""
    gt = batch["rotmats_gt"]
    m = batch["mask"]
    b, n = m.shape
    w = m[..., None, None, None]
    denom = torch.clamp(m.sum().to(torch.float32), min=1.0)
    coco = list(cfg.ALL_JOINTS_TO_COCO_MAP)
    zeros = torch.zeros((b * n, 10), device=gt.device)
    gt_flat = gt.reshape(-1, cfg.NUM_JOINTS, 3, 3)
    gt_joints = smpl_forward(assets, zeros, gt_flat[:, 1:],
                             gt_flat[:, :1]).joints[:, coco]

    def mse(x):
        return torch.sum(torch.where(w, (x - gt) ** 2, 0.0)) / (denom * 216.0)

    def angle_deg(x):
        rel = torch.einsum("bnjki,bnjkl->bnjil", gt, x)
        tr = torch.clamp((torch.diagonal(rel, dim1=-2, dim2=-1).sum(-1) - 1)
                         / 2, -1.0, 1.0)
        a = torch.rad2deg(torch.arccos(tr))
        return torch.sum(torch.where(m[..., None], a, 0.0)) \
            / (denom * cfg.NUM_JOINTS)

    def mpjpe(x):
        flat = x.reshape(-1, cfg.NUM_JOINTS, 3, 3)
        joints = smpl_forward(assets, zeros, flat[:, 1:],
                              flat[:, :1]).joints[:, coco]
        d = torch.linalg.vector_norm(joints - gt_joints, dim=-1).mean(-1)
        return torch.sum(torch.where(m, d.reshape(b, n), 0.0)) / denom \
            * 1000.0

    noisy = batch["rotmats_noisy"]
    return {"mse_in": mse(noisy), "mse_out": mse(refined),
            "angle_in_deg": angle_deg(noisy),
            "angle_out_deg": angle_deg(refined),
            "mpjpe_in_mm": mpjpe(noisy), "mpjpe_out_mm": mpjpe(refined)}


@torch.no_grad()
def evaluate_relation(relation: PoseRelationModule, assets: SMPLAssets,
                      n_batches: int = 8, b: int = 8, n_players: int = 6,
                      seed: int = EVAL_SEED,
                      draws: Optional[Sequence[RelationDraws]] = None,
                      device: DeviceLike = None) -> dict:
    """Held-out denoising metrics of ``relation`` on ``device`` (None: the
    CUDA card): the mean of :func:`relation_metrics` over ``n_batches``
    batches of ``b`` scenes of ``n_players``, drawn from a CPU generator
    seeded with ``seed`` unless ``draws`` (one per batch) are given."""
    dev = default_device(device)
    assets = on_device(assets, dev)
    relation = relation.to(dev).eval()
    if draws is None:
        gen = torch.Generator().manual_seed(seed)
        draws = [sample_relation_draws(gen, b, n_players)
                 for _ in range(n_batches)]
    sums: Optional[dict] = None
    for d in draws:
        batch = synth_relation_batch(d, device=dev)
        refined = relation(batch["rotmats_noisy"], batch["boxes"],
                           batch["mask"])
        m = {k: float(v) for k, v in
             relation_metrics(assets, batch, refined).items()}
        sums = m if sums is None else {k: sums[k] + m[k] for k in sums}
    out = {k: v / len(draws) for k, v in sums.items()}
    out["n_scenes"] = int(sum(d.eps.shape[0] for d in draws))
    return out
