"""Held-out evaluation of the inter-player pose relation module.

Counterpart of ``soccerplayershapepose_tpu/train/relation.py``: noisy-scene
tuples from
the scene factory (``train/scenes.py``: a shared team-action pose,
ball-facing orientations, broadcast-frame boxes), each player's ground-truth
rotmats perturbed per joint (a per-scene noise level plus heavy-tailed
outlier joints), a random number of real players per scene (the rest
padded), and the module's denoising measured before and after: rotmat MSE,
the mean per-joint geodesic angle and MPJPE through SMPL.

The trainer (:func:`train_relation`) learns to refine the noisy rotmats
with masked MSE to the ground truth over the 216 flattened entries, under
Adam with ``optax.warmup_cosine_decay_schedule(0, lr, steps // 10, steps,
0.05·lr)`` (:func:`warmup_cosine_decay`, evaluated at Adam's count before
the step, so the first update has rate 0). v0 starts with its value
projection ``WV`` zeroed, so the residual starts as the identity.

Randomness is explicit, as in ``train/scenes.py``: a sampler draws into
:class:`RelationDraws` and :func:`synth_relation_batch` is deterministic in
those draws; the trainer's initial weights and its batches come from two
seeded CPU generators.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.convert import (  # noqa: F401 (re-export)
    load_relation_weights, relation_flat_from_module)
from soccerplayershapepose_torch.models.init import flax_init_
from soccerplayershapepose_torch.models.relation import PoseRelationModule
from soccerplayershapepose_torch.ops.rotations import batch_rodrigues
from soccerplayershapepose_torch.pipeline.predict import on_device
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.smpl.model import smpl_forward
from soccerplayershapepose_torch.train.scenes import (
    OrientDraws, SceneDraws, orient_for_view, sample_orient_draws,
    sample_scene_draws, synth_scene_params)
from soccerplayershapepose_torch.train.optim import (
    Adam, warmup_cosine_decay)
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


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RelationTrainState:
    relation: PoseRelationModule
    opt: Adam
    step: int = 0


def new_relation(lift_dim: Optional[int] = None,
                 gen: Optional[torch.Generator] = None,
                 device: DeviceLike = None) -> PoseRelationModule:
    """v0 (``lift_dim`` None) or v1 (:data:`V1_KWARGS`) drawn from flax's
    initialisers with ``gen`` (a CPU generator; seed 0 if None), on
    ``device`` (None: the CUDA card). v0's value projection ``WV`` is
    zeroed, so its residual starts as the identity (refined == input)."""
    dev = default_device(device)
    relation = PoseRelationModule(**(V1_KWARGS if lift_dim else {}))
    flax_init_(relation, gen or torch.Generator().manual_seed(0))
    if lift_dim is None:
        with torch.no_grad():
            relation.WV.weight.zero_()
            relation.WV.bias.zero_()
    return relation.to(dev)


def make_relation_state(relation: PoseRelationModule, steps: int,
                        lr: float = 1e-3) -> RelationTrainState:
    """Adam over ``relation``'s parameters with the warmup-cosine rate of a
    ``steps``-step run."""
    return RelationTrainState(relation, Adam(
        list(relation.parameters()),
        warmup_cosine_decay(0.0, lr, max(steps // 10, 1), steps, lr * 0.05)))


def make_relation_train_step():
    """``step(state, batch) → (state, {loss, input_mse})``: one Adam update
    of the masked MSE between the refined and the ground-truth rotmats
    (``input_mse``: the same for the noisy input)."""
    def step(state: RelationTrainState, batch: dict):
        relation = state.relation.train()
        refined = relation(batch["rotmats_noisy"], batch["boxes"],
                           batch["mask"])
        m = batch["mask"][..., None, None, None]
        denom = torch.clamp(batch["mask"].sum().to(torch.float32),
                            min=1.0) * 216.0
        loss = torch.sum(torch.where(m, refined - batch["rotmats_gt"],
                                     0.0) ** 2) / denom
        with torch.no_grad():
            in_mse = torch.sum(torch.where(
                m, batch["rotmats_noisy"] - batch["rotmats_gt"], 0.0)
                ** 2) / denom
        state.opt.zero_grad()
        loss.backward()
        state.opt.step()
        state.step += 1
        return state, {"loss": loss.detach(), "input_mse": in_mse}
    return step


def train_relation(steps: int = 3000, b: int = 8, n_players: int = 6,
                   lr: float = 1e-3, lift_dim: Optional[int] = None,
                   seed: int = 0, log_every: int = 200,
                   verbose: bool = True, device: DeviceLike = None,
                   schedule_steps: Optional[int] = None,
                   relation: Optional[PoseRelationModule] = None,
                   batches: Optional[Iterable[dict]] = None):
    """Train a relation module on synthetic correlated scenes on ``device``
    (None: the CUDA card). ``lift_dim=1024`` selects v1
    (:data:`V1_KWARGS`). The initial weights come from a CPU generator
    seeded ``seed`` unless ``relation`` (a module to train in place) is
    given, the batches (b scenes of ``n_players``) from one seeded
    ``seed + 1`` unless ``batches`` (one dict of tensors per step) are
    given. ``schedule_steps`` (default ``steps``) sets the learning-rate
    schedule's length, so a run can stop after the first ``steps`` of a
    longer schedule. Returns (relation, history of {step, loss,
    input_mse} every ``log_every`` steps and at the last)."""
    dev = default_device(device)
    if relation is None:
        relation = new_relation(lift_dim, torch.Generator().manual_seed(seed),
                                dev)
    state = make_relation_state(relation.to(dev), schedule_steps or steps,
                                lr)
    step_fn = make_relation_train_step()
    data_gen = torch.Generator().manual_seed(seed + 1)
    given = None if batches is None else iter(batches)
    history = []
    for i in range(steps):
        if given is None:
            batch = synth_relation_batch(
                sample_relation_draws(data_gen, b, n_players), device=dev)
        else:
            batch = {k: v.to(dev) for k, v in next(given).items()}
        state, metrics = step_fn(state, batch)
        if (i + 1) % log_every == 0 or i + 1 == steps:
            rec = {"step": i + 1,
                   **{k: float(v) for k, v in metrics.items()}}
            history.append(rec)
            if verbose:
                print(f"relation step {rec['step']}: loss {rec['loss']:.5f} "
                      f"(input {rec['input_mse']:.5f})", flush=True)
    return state.relation.eval(), history


def save_relation_weights(path: str, relation: PoseRelationModule) -> None:
    """``relation``'s weights as the flat flax npz
    (``params/WQ/kernel`` …) that :func:`load_relation_weights`
    (``convert.load_relation_weights``) and the JAX package's
    ``load_relation_weights`` read."""
    np.savez(path, **relation_flat_from_module(relation))
