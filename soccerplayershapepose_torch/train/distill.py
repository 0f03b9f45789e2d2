"""Scene-batched distillation trainer of the regressor.

Counterpart of ``soccerplayershapepose_tpu/train/distill.py``: broadcast-view
fits act as pseudo ground truth, and per scene batch of players the
regressor is trained with the homoscedastic multi-task loss on verts, shape,
pose rotmats, joints2D (the projected KP-RCNN joints in 512² proxy pixels
against the proxy's keypoints) and joints3D (the COCO joint subset). One
Adam (β 0.9/0.999, ε 1e-8, as ``optax.adam``: ``train/optim.py``) runs over
the regressor's parameters and the criterion's log-variances together.

The train step runs the regressor in train mode: batch norm normalises by
the batch's statistics and updates its running ones as flax does
(``models/resnet.py:BatchNorm2d``). Padded players (the scene's last real
player repeated) enter those statistics, as in JAX, and only the loss masks
them. The eval step runs the regressor in eval mode without gradients.

A step mutates its :class:`TrainState` in place and returns it with the
metrics and the ``aux`` that the drivers' metric sums read. The proxy is
NCHW (B, C, 256, 256).

On a (data, model) grid (``make_train_step(mesh=...)``, the counterpart of
the JAX package's dry run, ``__graft_entry__.py:dryrun_multichip``) each
rank takes its slice of the batch (``parallel.mesh.shard_batch``) and a
state split by :func:`shard_train_state`: the IEF's large fc layers
column-parallel over ``model`` with their Adam moments, everything else
replicated. Batch norm and the multi-task means are global over ``data``
(each rank's loss is its share of the global loss, its log-variance terms
1 / data of theirs), every gradient is summed over ``data`` only, and the
metrics are the global batch's; ``aux`` holds the rank's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch import convert
from soccerplayershapepose_torch.losses.multi_task import (
    MultiTaskLossConfig, init_loss_state, multi_task_loss)
from soccerplayershapepose_torch.models.ief import (
    ColumnParallelLinear, default_initial_params)
from soccerplayershapepose_torch.models.init import flax_init_
from soccerplayershapepose_torch.models.regressor import SingleInputRegressor
from soccerplayershapepose_torch.ops.camera import (
    orthographic_project, undo_keypoint_normalisation)
from soccerplayershapepose_torch.ops.rotations import rot6d_to_rotmat
from soccerplayershapepose_torch.parallel.collectives import (
    all_gather_rows, coalesced_sum, data_parallel, data_size, sum_gradients)
from soccerplayershapepose_torch.pipeline.predict import on_device
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.smpl.model import (
    smpl_forward, smpl_shape_only)
from soccerplayershapepose_torch.train.optim import Adam
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, default_device)

DISTILL_TASKS = ("verts", "joints2D", "joints3D", "pose_params", "shape_params")
_MASKED = ("verts", "joints2D", "joints3D", "pose_params_rot_matrices",
           "shape_params")


@dataclasses.dataclass
class TrainState:
    """The regressor (its parameters and BN running statistics), the
    criterion's log-variances (leaf tensors), one Adam over both and the
    number of steps taken."""
    regressor: SingleInputRegressor
    log_vars: Dict[str, torch.Tensor]
    opt: Adam
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.regressor.parameters()).device


def new_regressor(in_channels: int = 18, seed: int = 0,
                  device: DeviceLike = None,
                  resnet_layers: int = 18) -> SingleInputRegressor:
    """A regressor (a ResNet-18 or -50 encoder) drawn from flax's default
    initialisers (``models/init.py``) with a CPU generator seeded
    ``seed``, on ``device`` (None: the CUDA card)."""
    dev = default_device(device)
    model = SingleInputRegressor(in_channels=in_channels,
                                 resnet_layers=resnet_layers)
    flax_init_(model, torch.Generator().manual_seed(seed))
    return model.to(dev)


def make_train_state(regressor: SingleInputRegressor,
                     losses_on: Sequence[str] = DISTILL_TASKS,
                     learning_rate=cfg.REGRESSOR_TRAIN_LR,
                     init_loss_weights: Optional[dict] = None) -> TrainState:
    """The trainer's state over ``regressor`` (on its device): log-variances
    ``−log(w + 1e-6)`` of ``init_loss_weights`` (0 where none is given) and
    Adam at ``learning_rate`` (a float or a schedule of the step count)
    over the regressor's parameters, then the log-variances in
    ``losses_on`` order."""
    dev = next(regressor.parameters()).device
    log_vars = {k: v.requires_grad_(True) for k, v in init_loss_state(
        losses_on, init_loss_weights, device=dev).items()}
    opt = Adam(list(regressor.parameters()) + list(log_vars.values()),
               learning_rate)
    return TrainState(regressor, log_vars, opt)


def shard_train_state(state: TrainState, mesh) -> TrainState:
    """Split ``state`` for its rank of ``mesh``, in place: the regressor's
    fc layers that split over the model axis become column-parallel
    (``models/ief.py``) and Adam's moments of their weights are cut with
    them (``convert.split_model_shards``); the rest stays replicated.
    Returns ``state``."""
    if mesh.n_model == 1:
        return state
    reg, opt = state.regressor, state.opt
    names = [n for n, _ in reg.named_parameters()]
    moments = {w: convert.split_model_shards(
        dict(zip(names, getattr(opt, w)[:len(names)])), mesh.n_model,
        mesh.model_index) for w in ("mu", "nu")}
    reg.ief.shard_columns(mesh.model_group, mesh.n_model, mesh.model_index)
    opt.params = list(reg.parameters()) + list(state.log_vars.values())
    for w in ("mu", "nu"):
        setattr(opt, w, [moments[w][n].clone() for n in names]
                + getattr(opt, w)[len(names):])
    return state


def gather_regressor(state: TrainState, mesh) -> dict:
    """The full regressor state dict on every rank of ``mesh``: each
    column-parallel weight gathered over its model row."""
    sd = state.regressor.state_dict()
    if mesh.n_model == 1:
        return dict(sd)
    full = {}
    for k, t in sd.items():
        owner = state.regressor.get_submodule(k.rsplit(".", 1)[0])
        split = (k.endswith(".weight")
                 and isinstance(owner, ColumnParallelLinear))
        full[k] = all_gather_rows(t, mesh.model_group) if split else t
    return full


def _forward_losses(state: TrainState, assets: SMPLAssets, batch: dict,
                    loss_cfg: MultiTaskLossConfig, train: bool):
    """Shared forward: proxy → regressor → SMPL → (total, aux); inside
    ``parallel.collectives.data_parallel`` the rank's share of the global
    batch's losses (its rows are 1 / data of the batch)."""
    reg = state.regressor.train(train)
    init = default_initial_params(assets.mean_pose_rot6d, assets.mean_shape)
    cam_wp, pose6d, betas = reg(batch["proxy"], init)
    rotmats = rot6d_to_rotmat(pose6d.reshape(-1, cfg.NUM_JOINTS, 6))
    pred = smpl_forward(assets, betas, rotmats[:, 1:], rotmats[:, :1])
    with torch.no_grad():
        target = smpl_forward(assets, batch["target_betas"],
                              batch["target_pose"][:, 1:],
                              batch["target_pose"][:, :1])
        target_reposed = smpl_shape_only(assets, batch["target_betas"])
    coco = list(cfg.ALL_JOINTS_TO_COCO_MAP)
    j2d = undo_keypoint_normalisation(
        orthographic_project(pred.joints, cam_wp)[
            :, list(cfg.SMPL_TO_KPRCNN_MAP)], cfg.PROXY_REP_INPUT_WH)
    outputs = {"verts": pred.vertices, "joints2D": j2d,
               "joints3D": pred.joints[:, coco],
               "pose_params_rot_matrices": rotmats, "shape_params": betas}
    labels = {"verts": target.vertices,
              "joints2D": batch["joints2d"][..., :2],
              "joints3D": target.joints[:, coco],
              "pose_params_rot_matrices": batch["target_pose"],
              "shape_params": batch["target_betas"]}
    if "mask" in batch:
        # Padded players: both sides zeroed, so every MSE term ignores them.
        m = batch["mask"].to(torch.float32)
        for key in _MASKED:
            shape_mask = m.reshape(m.shape + (1,) * (outputs[key].dim() - 1))
            outputs[key] = outputs[key] * shape_mask
            labels[key] = labels[key] * shape_mask
    share = 1.0 / data_size()
    total, task_losses = multi_task_loss(
        state.log_vars, outputs, labels, loss_cfg,
        {t: share for t in loss_cfg.losses_on})
    with torch.no_grad():
        aux = {"task_losses": {k: v.detach() for k, v in task_losses.items()},
               "pred": {"verts": pred.vertices.detach(),
                        "joints3D": pred.joints.detach(),
                        "betas": betas.detach(),
                        "pose_rotmats": rotmats.detach(),
                        "cam_wp": cam_wp.detach(),
                        "reposed_verts": smpl_shape_only(assets,
                                                         betas.detach())},
               "target": {"verts": target.vertices,
                          "joints3D": target.joints,
                          "betas": batch["target_betas"],
                          "pose_rotmats": batch["target_pose"],
                          "reposed_verts": target_reposed}}
    return total, aux


def _metrics(total, aux) -> dict:
    return {"loss": total.detach(),
            **{"loss/" + k: v for k, v in aux["task_losses"].items()}}


def make_train_step(losses_on: Sequence[str] = DISTILL_TASKS, mesh=None):
    """``step(state, assets, batch) → (state, metrics, aux)``: one Adam
    update of the regressor and the log-variances, BN statistics updated.

    batch: {'proxy' (B, C, 256, 256), 'joints2d' (B, 17, 2|3) px at 512,
    'target_pose' (B, 24, 3, 3), 'target_betas' (B, 10), 'mask' (B,)?},
    on the state's device; ``assets`` is moved there if need be. With
    ``mesh`` the batch is the rank's slice and the state
    :func:`shard_train_state`'s (see the module docstring)."""
    loss_cfg = MultiTaskLossConfig(losses_on=tuple(losses_on))
    group = None if mesh is None else mesh.data_group

    def step(state: TrainState, assets: SMPLAssets, batch: dict):
        assets = on_device(assets, state.device)
        with data_parallel(group):
            total, aux = _forward_losses(state, assets, batch, loss_cfg,
                                         train=True)
            state.opt.zero_grad()
            total.backward()
        sum_gradients(state.opt.params, group)
        state.opt.step()
        state.step += 1
        metrics = _metrics(total, aux)
        if group is not None:
            metrics = dict(zip(metrics, coalesced_sum(list(
                metrics.values()), group)))
        return state, metrics, aux

    return step


def make_eval_step(losses_on: Sequence[str] = DISTILL_TASKS):
    """``step(state, assets, batch) → (metrics, aux)``: the validation
    forward in eval mode, no update."""
    loss_cfg = MultiTaskLossConfig(losses_on=tuple(losses_on))

    @torch.no_grad()
    def step(state: TrainState, assets: SMPLAssets, batch: dict):
        assets = on_device(assets, state.device)
        total, aux = _forward_losses(state, assets, batch, loss_cfg,
                                     train=False)
        return _metrics(total, aux), aux

    return step
