"""Homoscedastic-uncertainty weighted multi-task loss (Kendall et al.).

Counterpart of ``soccerplayershapepose_tpu/losses/multi_task.py``, with its
quirks kept for parity with the reference criterion:

* per task ``total += mse · exp(−log_var) + log_var`` (mean-reduced MSE);
* joints2D: prediction and label are both normalised by
  ``2j/REGRESSOR_IMG_WH − 1``, i.e. by 256 although they live in 512 space;
  an optional per-joint visibility weight restricts the mean;
* silhouette: ``Σ pred·log(target+1e-6) + (1−pred)·log(1−target+1e-6)``,
  pred and target in swapped BCE roles, added as ``−that·exp(−lv) + lv``.

Log-variances start at ``−log(w + 1e-6)`` of the initial loss weights; the
fitting loops keep them fixed. Inside ``parallel.collectives.data_parallel``
a rank adds 1 / (its data group's size) of each log-variance, so that the
ranks' losses sum to the global batch's, with each ``+ log_var`` counted
once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.parallel.collectives import data_size


@dataclasses.dataclass(frozen=True)
class MultiTaskLossConfig:
    losses_on: Sequence[str] = ("joints2D",)
    img_wh: int = cfg.REGRESSOR_IMG_WH


def init_loss_state(losses_on: Sequence[str],
                    init_loss_weights: Optional[dict] = None,
                    eps: float = 1e-6, device="cpu") -> dict:
    """{task: fp32 scalar log-variance} for each active task."""
    state = {}
    for task in losses_on:
        if init_loss_weights and task in init_loss_weights:
            lv = -np.log(init_loss_weights[task] + eps)
        else:
            lv = 0.0
        state[task] = torch.tensor(np.float32(lv), device=device)
    return state


def _masked_mse(pred, target, mask=None):
    se = (pred - target) ** 2
    if mask is None:
        return torch.mean(se)
    m = torch.broadcast_to(mask[..., None], se.shape).to(se.dtype)
    return torch.sum(se * m) / torch.clamp(torch.sum(m), min=1.0)


def multi_task_loss(log_vars: dict, outputs: dict, labels: dict,
                    config: MultiTaskLossConfig,
                    task_scales: Optional[dict] = None):
    """Weighted total loss and {task: weighted task loss}.

    Tasks: 'verts' (B, V, 3), 'joints2D' (B, J, 2) px with optional
    labels['vis'] (B, J) weights, 'joints3D' (B, J, 3), 'shape_params'
    (B, 10), 'pose_params' (outputs['pose_params_rot_matrices']) and
    'silhouette' (B, H, W). ``task_scales`` multiplies a raw task loss
    before weighting.
    """
    lv_share = 1.0 / data_size()
    total = 0.0
    loss_dict = {}

    def add(task, raw, negate=False):
        if task_scales is not None and task in task_scales:
            raw = raw * task_scales[task]
        lv = log_vars[task]
        weighted = raw * torch.exp(-lv)
        loss_dict[task] = weighted
        return (-weighted if negate else weighted) + lv * lv_share

    losses_on = config.losses_on
    if "verts" in losses_on:
        total = total + add("verts", _masked_mse(outputs["verts"],
                                                 labels["verts"]))
    if "joints2D" in losses_on:
        pred = (2.0 * outputs["joints2D"]) / config.img_wh - 1.0
        label = (2.0 * labels["joints2D"]) / config.img_wh - 1.0
        total = total + add("joints2D",
                            _masked_mse(pred, label, labels.get("vis")))
    for task in ("joints3D", "shape_params"):
        if task in losses_on:
            total = total + add(task, _masked_mse(outputs[task], labels[task]))
    if "pose_params" in losses_on:
        total = total + add("pose_params", _masked_mse(
            outputs["pose_params_rot_matrices"],
            labels["pose_params_rot_matrices"]))
    if "silhouette" in losses_on:
        p = outputs["silhouette"]
        t = labels["silhouette"]
        raw = torch.sum(p * torch.log(t + 1e-6)
                        + (1.0 - p) * torch.log(1.0 - t + 1e-6))
        total = total + add("silhouette", raw, negate=True)
    return total, loss_dict
