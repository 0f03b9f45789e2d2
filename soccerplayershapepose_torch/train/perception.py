"""Training loops for the perception nets (ProxyNet and the player detector).

Counterpart of ``soccerplayershapepose_tpu/train/perception.py``: both nets
train end to end on the synthetic SMPL render factory (``train/synth.py``),
one batch rendered per step. On the card the render runs K3 inside every
step: a ProxyNet batch is z-buffered at the crop size and again at stride 4
(a player and an occluder per crop), a detector batch once at max(h, w)²
with all its players.

Losses, as the JAX package's:

* keypoints: the penalty-reduced focal loss (CenterNet) on the sigmoided
  stride-4 heatmaps against Gaussian targets (σ 1.5 cells) normalised to 1
  at their peak and multiplied by each joint's visibility; positives are
  the cells whose target is ≥ 0.999;
* silhouette: full-resolution binary cross-entropy with logits;
* IUV: softmax cross-entropy over background and 24 parts, and the L1 of
  the ground-truth part's U, V inside the body, both weighted by each
  crop's ``iuv_valid`` (real-proxy crops may have no IUV labels);
* detector: ``models/detector.py:detector_loss`` on the targets of
  :func:`center_targets`, players whose visible fill is below
  ``min_visible_fill`` left out of them.

Batches follow the JAX package's contract, channels last (``image (B, H,
W, 3)`` in [0, 1]); the step permutes the images once for the NCHW nets.
A step updates its :class:`PerceptionTrainState` in place: the net in train
mode (batch norm with flax's update of the running statistics,
``models/resnet.py:BatchNorm2d``) and one Adam as ``optax.adam``
(``train/optim.py``). Randomness is explicit: a trainer draws its initial
weights (``models/init.py:flax_init_``) and then every batch from one
``torch.Generator``.

The weights are saved as a flat npz in the JAX package's layout (f16 on
request), so either package loads the other's.

:func:`shard_train_step` makes a step data-parallel over a mesh's data
axis, as the JAX package's does under GSPMD: the state replicated, the
batch split on its leading axis, batch norm over the global batch, every
loss denominator (the keypoint positives, the IUV-valid crops, the
foreground cells, the mean's elements) summed over the ranks before it
divides, and the gradients summed, so the step equals the one-process
step on the whole batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.nn import functional as F

from soccerplayershapepose_torch.convert import (
    _load_strict, _read_flat, detector_state_dict_from_flat,
    proxynet_flat_from_state_dict, proxynet_state_dict_from_flat)
from soccerplayershapepose_torch.models.detector import (
    PlayerDetector, center_targets, detector_loss)
from soccerplayershapepose_torch.models.init import flax_init_
from soccerplayershapepose_torch.models.perception import (
    NUM_PARTS, STRIDE, ProxyNet)
from soccerplayershapepose_torch.parallel.collectives import (
    coalesced_sum, current_data_group, data_parallel, data_share, data_sum,
    sum_gradients)
from soccerplayershapepose_torch.pipeline.predict import on_device
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.train.optim import Adam
from soccerplayershapepose_torch.train.synth import (
    render_crop_batch, render_frame_batch, sample_crop_draws,
    sample_frame_draws)
from soccerplayershapepose_torch.utils import profiling
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, default_device)

PerceptionNet = Union[ProxyNet, PlayerDetector]
MIN_VISIBLE_FILL = 0.08


@dataclasses.dataclass
class PerceptionTrainState:
    """The net (its parameters and BN running statistics), one Adam over
    its parameters, the steps taken and each step's losses (detached
    tensors, read when the caller wants them)."""
    model: PerceptionNet
    opt: Adam
    step: int = 0
    history: List[Dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=list)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def make_perception_state(model: PerceptionNet,
                          learning_rate=1e-3) -> PerceptionTrainState:
    """Adam at ``learning_rate`` over ``model``'s parameters, on its
    device."""
    return PerceptionTrainState(model, Adam(list(model.parameters()),
                                            learning_rate))


def gaussian_heatmap_targets(joints2d: torch.Tensor, wh: int,
                             sigma: float = 1.5) -> torch.Tensor:
    """Smooth (untruncated) Gaussian targets (B, wh, wh, K) at the joints'
    (B, K, 2) positions, pixel centres at +0.5; the training targets, not
    the reference's truncated input heatmaps (``ops/heatmaps.py``)."""
    grid = torch.arange(wh, dtype=torch.float32,
                        device=joints2d.device) + 0.5
    dy = grid[None, :, None] - joints2d[..., 1][:, None, :]     # (B, wh, K)
    dx = grid[None, :, None] - joints2d[..., 0][:, None, :]
    gy = torch.exp(-dy ** 2 / (2 * sigma ** 2))
    gx = torch.exp(-dx ** 2 / (2 * sigma ** 2))
    return gy[:, :, None, :] * gx[:, None, :, :]


def _nchw(image: torch.Tensor) -> torch.Tensor:
    return image.permute(0, 3, 1, 2)


def proxynet_losses(model: ProxyNet, batch: dict, train: bool = True
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward and every head's loss on a batch: ``image (B, wh, wh, 3)``,
    ``silhouette (B, wh, wh)``, ``joints2d (B, 17, 2)`` px, optional
    ``kp_visible (B, 17)``, and for the IUV head ``part (B, wh/4, wh/4)``,
    ``uv (B, wh/4, wh/4, 2)`` and optional ``iuv_valid (B,)``. In train
    mode batch norm normalises by the batch and updates its statistics.
    Returns ``(total, {"kp", "mask"[, "part", "uv"], "total"})``; inside
    ``parallel.collectives.data_parallel`` the rank's share of the global
    batch's losses."""
    out = model.train(train)(_nchw(batch["image"]))
    wh = batch["image"].shape[1]
    small = wh // STRIDE
    kp_t = gaussian_heatmap_targets(batch["joints2d"] * (small / wh), small,
                                    sigma=1.5)
    kp_t = kp_t / torch.clamp(torch.amax(kp_t, dim=(1, 2), keepdim=True),
                              min=1e-6)
    vis = batch.get("kp_visible")
    if vis is None:
        vis = torch.ones(kp_t.shape[:1] + kp_t.shape[-1:],
                         device=kp_t.device)
    kp_t = kp_t * vis[:, None, None, :]
    kp_p = torch.sigmoid(out.kp_logits)
    pos = (kp_t >= 0.999).to(torch.float32)
    eps = 1e-6
    pos_term = -torch.log(kp_p + eps) * (1 - kp_p) ** 2 * pos
    neg_term = -torch.log(1 - kp_p + eps) * kp_p ** 2 * (1 - kp_t) ** 4 \
        * (1 - pos)
    n_pos = torch.clamp(data_sum(torch.sum(pos)), min=1.0)
    kp_loss = (torch.sum(pos_term) + torch.sum(neg_term)) / n_pos
    mask_loss = F.binary_cross_entropy_with_logits(
        out.mask_logits, batch["silhouette"])
    mask_loss = mask_loss * data_share(out.mask_logits.numel(),
                                       out.mask_logits.device)
    losses = {"kp": kp_loss, "mask": mask_loss}
    total = kp_loss + mask_loss
    if model.with_iuv and out.part_logits is not None:
        part_t = batch["part"].to(torch.int64)
        iuv_valid = batch.get("iuv_valid")
        if iuv_valid is None:
            iuv_valid = torch.ones(part_t.shape[:1], device=part_t.device)
        n_valid = torch.clamp(data_sum(torch.sum(iuv_valid)), min=1.0)
        ce = F.cross_entropy(_nchw(out.part_logits), part_t,
                             reduction="none")                   # (B, s, s)
        part_loss = torch.sum(ce.mean(dim=(1, 2)) * iuv_valid) / n_valid
        fg = (part_t > 0).to(torch.float32) * iuv_valid[:, None, None]
        sel = torch.clamp(part_t - 1, 0, NUM_PARTS - 1)
        uv_p = torch.sigmoid(out.uv.reshape(out.uv.shape[:3]
                                            + (NUM_PARTS, 2)))
        uv_sel = torch.gather(uv_p, 3, sel[..., None, None].expand(
            -1, -1, -1, 1, 2))[..., 0, :]
        uv_loss = torch.sum(torch.abs(uv_sel - batch["uv"]) * fg[..., None]) \
            / torch.clamp(data_sum(torch.sum(fg)) * 2.0, min=1.0)
        losses["part"] = part_loss
        losses["uv"] = uv_loss
        total = total + part_loss + uv_loss
    losses["total"] = total
    return total, losses


def _update(state: PerceptionTrainState, total: torch.Tensor) -> None:
    state.opt.zero_grad()
    total.backward()
    sum_gradients(state.opt.params, current_data_group())
    state.opt.step()
    state.step += 1


def _global(losses: dict) -> dict:
    """The losses detached; under ``data_parallel`` summed over the data
    group (each rank's are its shares)."""
    group = current_data_group()
    return dict(zip(losses, coalesced_sum(list(losses.values()), group)))


def make_proxynet_train_step():
    """``step(state, batch) → (state, losses)``: one Adam update of
    ProxyNet on :func:`proxynet_losses`, BN statistics updated; the batch
    on the state's device."""
    def step(state: PerceptionTrainState, batch: dict):
        total, losses = proxynet_losses(state.model, batch, train=True)
        _update(state, total)
        return state, _global(losses)
    return step


def make_detector_train_step(min_visible_fill: float = MIN_VISIBLE_FILL):
    """``step(state, batch) → (state, losses)``: one Adam update of the
    detector on ``detector_loss``. The batch: ``image (B, H, W, 3)``,
    ``boxes (B, N, 4)`` px, ``mask (B, N)`` and optional ``visible_fill
    (B, N)``; players whose visible fill is below ``min_visible_fill``
    (more than ~80% hidden: a fully visible player fills ~0.35-0.45) are
    left out of the targets, so the net is not taught to find players
    hidden behind others."""
    def step(state: PerceptionTrainState, batch: dict):
        image = batch["image"]
        mask = batch["mask"]
        if min_visible_fill and "visible_fill" in batch:
            mask = mask * (batch["visible_fill"]
                           >= min_visible_fill).to(mask.dtype)
        targets = center_targets(batch["boxes"], mask, image.shape[1:3])
        out = state.model.train(True)(_nchw(image))
        total, parts = detector_loss(out, targets, mask)
        _update(state, total)
        return state, _global(dict(parts, total=total))
    return step


def shard_train_step(step_fn, mesh):
    """A perception step (:func:`make_proxynet_train_step`'s or
    :func:`make_detector_train_step`'s) made data-parallel over ``mesh``'s
    data axis: ``step(state, batch)`` with the state replicated on every
    rank (``parallel.mesh.replicate``) and ``batch`` the rank's slice of
    the global batch (``parallel.mesh.shard_batch``; the batch must be a
    multiple of the data axis). Inside, batch norm's moments and every
    loss denominator are the global batch's, each rank's loss is its share
    of the global loss and the gradients are summed over the data group,
    so the replicas stay identical and the step equals the one-process
    step on the whole batch (unlike per-replica batch norm, the DDP
    idiom). The losses returned are the global batch's."""
    group = mesh.data_group

    def step(state: PerceptionTrainState, batch: dict):
        with data_parallel(group):
            return step_fn(state, batch)
    return step


def new_proxynet(gen: torch.Generator, with_iuv: bool = True,
                 device: DeviceLike = None, channels: int = 128) -> ProxyNet:
    """ProxyNet (head width ``channels``) drawn from flax's default
    initialisers with ``gen`` (a CPU generator), on ``device`` (None: the
    CUDA card)."""
    dev = default_device(device)
    return flax_init_(ProxyNet(with_iuv=with_iuv, channels=channels),
                      gen).to(dev)


def new_detector(gen: torch.Generator, device: DeviceLike = None,
                 channels: int = 128) -> PlayerDetector:
    """The player detector drawn as :func:`new_proxynet` draws ProxyNet."""
    dev = default_device(device)
    return flax_init_(PlayerDetector(channels=channels), gen).to(dev)


def save_perception_weights(path: str, model: PerceptionNet, dtype=None,
                            compress: bool = False) -> None:
    """Save ProxyNet's or the detector's variables as a flat npz in the JAX
    package's layout (``params/...``, ``batch_stats/...``; kernels HWIO).
    ``dtype=np.float16`` with ``compress=True`` is the committed weights'
    packing; :func:`load_perception_weights` casts back to fp32."""
    flat = proxynet_flat_from_state_dict(model.state_dict())
    if dtype is not None:
        flat = {k: v.astype(dtype) if v.dtype == np.float32 else v
                for k, v in flat.items()}
    (np.savez_compressed if compress else np.savez)(path, **flat)


def load_perception_weights(path: str, model: PerceptionNet
                            ) -> PerceptionNet:
    """Load a flat npz of either package (:func:`save_perception_weights`,
    JAX's ``save_perception_weights``) into ``model`` in place, on its
    device. The load is strict: a missing or an unexpected variable, or one
    of another shape (``load_state_dict``), raises. Returns ``model``."""
    flat = _read_flat(path)
    sd = (detector_state_dict_from_flat(flat)
          if isinstance(model, PlayerDetector)
          else proxynet_state_dict_from_flat(flat))
    return _load_strict(model, sd, path, type(model).__name__)


def _log(kind: str, i: int, steps: int, losses: dict) -> None:
    print(f"{kind} step {i + 1}/{steps}: " + " ".join(
        f"{k}={float(v):.4f}" for k, v in losses.items()), flush=True)


def _train_loop(kind: str, state: PerceptionTrainState, step_fn, draw,
                render, steps: int, log_every: int,
                stage_times: Optional[dict]) -> PerceptionTrainState:
    stage = profiling.Stages(stage_times, state.device, prefix=f"{kind}.")
    for i in range(steps):
        with stage("synthesis"):
            batch = render(draw())
        with stage("step"):
            state, losses = step_fn(state, batch)
        state.history.append(losses)
        if log_every and (i + 1) % log_every == 0:
            _log(kind, i, steps, losses)
    return state


def train_proxynet_synth(assets: SMPLAssets, steps: int = 200,
                         batch: int = 8, wh: int = 256,
                         learning_rate: float = 1e-3, with_iuv: bool = True,
                         seed: int = 0, log_every: int = 50,
                         init_weights: Optional[str] = None,
                         stage_times: Optional[dict] = None,
                         device: DeviceLike = None) -> PerceptionTrainState:
    """Train ProxyNet on the synthetic crop factory on ``device`` (None:
    the CUDA card): each step renders ``batch`` domain-randomised RGB crops
    of wh² with occluders (``sample_crop_draws`` → ``render_crop_batch``,
    K3 twice on the card) and takes one Adam step. One CPU generator
    seeded ``seed`` draws the initial weights (flax's initialisers; none
    when the net starts from ``init_weights``, a flat npz) and then every
    batch. ``stage_times``, a dict, receives the synchronised wall seconds
    of ``synthesis`` and ``step``. Returns the final state."""
    dev = default_device(device)
    gen = torch.Generator().manual_seed(seed)
    if init_weights is None:
        model = new_proxynet(gen, with_iuv, device=dev)
    else:
        model = load_perception_weights(
            init_weights, ProxyNet(with_iuv=with_iuv)).to(dev)
    assets = on_device(assets, dev)
    state = make_perception_state(model, learning_rate)
    return _train_loop(
        "proxynet", state, make_proxynet_train_step(),
        lambda: sample_crop_draws(gen, batch, image_wh=wh),
        lambda d: render_crop_batch(assets, d, wh, with_image=True),
        steps, log_every, stage_times)


def train_detector_synth(assets: SMPLAssets, steps: int = 200,
                         batch: int = 4, hw: Tuple[int, int] = (256, 448),
                         n_players: int = 6, learning_rate: float = 1e-3,
                         seed: int = 0, log_every: int = 50,
                         init_weights: Optional[str] = None,
                         stage_times: Optional[dict] = None,
                         device: DeviceLike = None) -> PerceptionTrainState:
    """Train the player detector on synthetic frames of ``n_players``
    (``sample_frame_draws`` → ``render_frame_batch``: one K3 pass at
    max(h, w)² per batch on the card), as :func:`train_proxynet_synth`
    trains ProxyNet."""
    dev = default_device(device)
    gen = torch.Generator().manual_seed(seed)
    if init_weights is None:
        model = new_detector(gen, device=dev)
    else:
        model = load_perception_weights(init_weights,
                                        PlayerDetector()).to(dev)
    assets = on_device(assets, dev)
    state = make_perception_state(model, learning_rate)
    return _train_loop(
        "detector", state, make_detector_train_step(),
        lambda: sample_frame_draws(gen, batch, n_players, hw),
        lambda d: render_frame_batch(assets, d, hw),
        steps, log_every, stage_times)
