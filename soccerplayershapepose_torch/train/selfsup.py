"""Self-supervised fine-tuning of the regressor on proxies alone.

Counterpart of ``soccerplayershapepose_tpu/train/selfsup.py``: the loss goes
through the whole prediction path, proxy → regressor → SMPL → weak-
perspective joint projection and the differentiable soft silhouette, with
the homoscedastic multi-task loss on

* ``item='pose'``: joints2D only;
* ``item='shape'``: the silhouette only;
* ``item='both'``: both (initial weights {1.0, 1.0}),

and Adam at ``FITTING_LR`` 1e-3 over the regressor's parameters and the
criterion's log-variances (``train/distill.py:TrainState``).

The silhouette renders at σ = 1e-4 through ``render/softras.py:
render_silhouette``: on the card K1 forward and K2 backward
(``render/band_raster.py:SoftSilhouetteBand``), so K2's gradient flows into
the ResNet's weights; on the CPU the plain version. Where ``render_wh`` is
below the target's size the target is stride-subsampled to it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.losses.multi_task import (
    MultiTaskLossConfig, multi_task_loss)
from soccerplayershapepose_torch.models.ief import default_initial_params
from soccerplayershapepose_torch.models.regressor import SingleInputRegressor
from soccerplayershapepose_torch.ops.camera import (
    orthographic_project, undo_keypoint_normalisation,
    weak_perspective_to_translation)
from soccerplayershapepose_torch.ops.rotations import rot6d_to_rotmat
from soccerplayershapepose_torch.ops.segmentation import (
    silhouette_confusion_metrics)
from soccerplayershapepose_torch.pipeline.predict import on_device
from soccerplayershapepose_torch.render.softras import render_silhouette
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.smpl.model import smpl_forward
from soccerplayershapepose_torch.train.distill import (
    TrainState, make_train_state)

SELFSUP_SIGMA = 1e-4


def losses_for_item(item: str) -> Sequence[str]:
    if item == "pose":
        return ("joints2D",)
    if item == "shape":
        return ("silhouette",)
    return ("joints2D", "silhouette")


def make_selfsup_state(regressor: SingleInputRegressor, item: str = "pose",
                       learning_rate: float = cfg.FITTING_LR) -> TrainState:
    """The trainer's state over ``regressor`` for ``item``: log-variances
    from the weights {joints2D: 1.0, silhouette: 1.0}, Adam at
    ``learning_rate``."""
    return make_train_state(regressor, losses_for_item(item), learning_rate,
                            {"joints2D": 1.0, "silhouette": 1.0})


def make_selfsup_step(item: str = "pose",
                      render_wh: int = cfg.PROXY_REP_INPUT_WH,
                      sigma: float = SELFSUP_SIGMA, train: bool = True):
    """The self-supervised step.

    batch: {'proxy' (B, C, 256, 256), 'silhouette' (B, 512, 512),
    'joints2d' (B, 17, 2|3), 'mask' (B,)?} on the state's device.
    ``train=True`` gives ``step(state, assets, batch) → (state,
    metrics{loss, joints2D_l2e, silh_iou}, aux)`` (one Adam update, BN
    statistics updated); ``train=False`` gives ``step(...) → (metrics,
    aux)`` in eval mode without gradients.
    """
    losses_on = losses_for_item(item)
    loss_cfg = MultiTaskLossConfig(losses_on=losses_on)
    use_sil = "silhouette" in losses_on

    def forward(state: TrainState, assets: SMPLAssets, batch: dict):
        reg = state.regressor.train(train)
        init = default_initial_params(assets.mean_pose_rot6d,
                                      assets.mean_shape)
        cam_wp, pose6d, betas = reg(batch["proxy"], init)
        rotmats = rot6d_to_rotmat(pose6d.reshape(-1, cfg.NUM_JOINTS, 6))
        out = smpl_forward(assets, betas, rotmats[:, 1:], rotmats[:, :1])
        j2d = undo_keypoint_normalisation(
            orthographic_project(out.joints, cam_wp)[
                :, list(cfg.SMPL_TO_KPRCNN_MAP)], cfg.PROXY_REP_INPUT_WH)
        mask = batch.get("mask")
        if mask is None:
            mask = torch.ones((j2d.shape[0],), device=j2d.device)
        m3 = mask.to(torch.float32)[:, None, None]
        target_j2d = batch["joints2d"][..., :2]
        outputs = {"joints2D": j2d * m3}
        labels = {"joints2D": target_j2d * m3}
        pred_sil = target_sil = None
        if use_sil:
            translation = weak_perspective_to_translation(
                cam_wp, cfg.FOCAL_LENGTH, cfg.PROXY_REP_INPUT_WH)
            pred_sil = render_silhouette(
                out.vertices, translation, assets.faces,
                cfg.PROXY_REP_INPUT_WH, cfg.FOCAL_LENGTH, sigma=sigma,
                render_wh=render_wh)
            target_sil = batch["silhouette"]
            if render_wh != target_sil.shape[-1]:
                stride = target_sil.shape[-1] // render_wh
                target_sil = target_sil[..., ::stride, ::stride]
            outputs["silhouette"] = pred_sil * m3
            labels["silhouette"] = target_sil * m3
        total, task_losses = multi_task_loss(state.log_vars, outputs, labels,
                                             loss_cfg)
        with torch.no_grad():
            j2d_l2e = torch.mean(torch.linalg.vector_norm(
                j2d - target_j2d, dim=-1))
            iou = (torch.mean(silhouette_confusion_metrics(
                pred_sil, target_sil)["iou"]) if use_sil
                else torch.zeros((), device=j2d.device))
        aux = {"task_losses": {k: v.detach() for k, v in task_losses.items()},
               "j2d_l2e": j2d_l2e, "silh_iou": iou,
               "pred_j2d": j2d.detach()}
        metrics = {"loss": total.detach(), "joints2D_l2e": j2d_l2e,
                   "silh_iou": iou}
        return total, metrics, aux

    if not train:
        @torch.no_grad()
        def eval_step(state: TrainState, assets: SMPLAssets, batch: dict):
            _, metrics, aux = forward(
                state, on_device(assets, state.device), batch)
            return metrics, aux
        return eval_step

    def step(state: TrainState, assets: SMPLAssets, batch: dict):
        total, metrics, aux = forward(
            state, on_device(assets, state.device), batch)
        state.opt.zero_grad()
        total.backward()
        state.opt.step()
        state.step += 1
        return state, metrics, aux

    return step
