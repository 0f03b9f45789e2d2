"""Checkpoint save and restore of the distillation trainer.

Counterpart of ``soccerplayershapepose_tpu/train/checkpoint.py``, in its
layout, so a JAX checkpoint's weights restore into the port and the port's
into JAX::

    <dir>/<tag>/params.npz       regressor parameters, flax names and layouts
                                 (``ResNet_0/Conv_0/kernel`` HWIO, …)
    <dir>/<tag>/batch_stats.npz  BN running statistics (``ResNet_0/
                                 BatchNorm_0/mean``, …)
    <dir>/<tag>/log_vars.npz     the criterion's log-variances by task
    <dir>/<tag>/best_params.npz  the best epoch's parameters, as params.npz
    <dir>/<tag>/opt_state.npz    the port's Adam (``train/optim.py``):
                                 ``count``, ``mu/params/<name>``,
                                 ``nu/params/<name>`` (flax names and
                                 layouts) and ``mu/log_vars/<task>``,
                                 ``nu/log_vars/<task>``
    <dir>/<tag>/meta.json        epoch, best_epoch, best_epoch_val_metrics,
                                 save_val_metrics, step

written into ``<tag>.tmp`` and renamed into place. ``opt_state.npz`` is the
port's own (optax's state has other names); the rest reads both ways.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from soccerplayershapepose_torch.convert import (
    from_flax_layout, regressor_flat_from_state_dict, regressor_flax_name,
    regressor_state_dict_from_flat, to_flax_layout)
from soccerplayershapepose_torch.train.distill import TrainState


def _strip(flat: dict, col: str) -> dict:
    n = len(col) + 1
    return {k[n:]: v for k, v in flat.items() if k.startswith(col + "/")}


def _prefix(flat: dict, col: str) -> dict:
    return {"%s/%s" % (col, k): v for k, v in flat.items()}


def regressor_flat(state: TrainState) -> Tuple[dict, dict]:
    """The regressor's (params, batch_stats) as flat flax variables without
    their collection prefix, as the JAX checkpoints hold them."""
    flat = regressor_flat_from_state_dict(state.regressor.state_dict(),
                                          state.regressor.resnet_layers)
    return _strip(flat, "params"), _strip(flat, "batch_stats")


def params_snapshot(state: TrainState) -> dict:
    """A copy of the regressor's parameters (flat flax names, numpy): what
    the trainer keeps as the best epoch's ``best_params``."""
    return regressor_flat(state)[0]


def _opt_keys(state: TrainState) -> list:
    """The name of each of the optimizer's tensors (the regressor's
    parameters, then the log-variances), in its order."""
    layers = state.regressor.resnet_layers
    return ([regressor_flax_name(n, layers)
             for n, _ in state.regressor.named_parameters()]
            + ["log_vars/" + k for k in state.log_vars])


def _opt_flat(state: TrainState) -> dict:
    out = {"count": np.asarray(state.opt.count, np.int32)}
    for which, moments in (("mu", state.opt.mu), ("nu", state.opt.nu)):
        for key, m in zip(_opt_keys(state), moments):
            a = m.detach().cpu().numpy()
            out["%s/%s" % (which, key)] = (to_flax_layout(a)
                                           if key.endswith("/kernel") else a)
    return out


class CheckpointManager:
    """Save and restore the trainer's state with the current and best
    weights."""

    def __init__(self, directory: str, save_val_metrics: Optional[list] = None):
        self.directory = directory
        self.save_val_metrics = save_val_metrics or []
        os.makedirs(directory, exist_ok=True)

    def save(self, epoch: int, state: TrainState, best_params: dict,
             best_epoch: int, best_epoch_val_metrics: Dict[str, float],
             tag: str = "latest") -> str:
        ckpt_dir = os.path.join(self.directory, tag)
        tmp_dir = ckpt_dir + ".tmp"
        if os.path.exists(tmp_dir):
            shutil.rmtree(tmp_dir)
        os.makedirs(tmp_dir)
        params, stats = regressor_flat(state)
        np.savez(os.path.join(tmp_dir, "params.npz"), **params)
        np.savez(os.path.join(tmp_dir, "batch_stats.npz"), **stats)
        np.savez(os.path.join(tmp_dir, "log_vars.npz"),
                 **{k: v.detach().cpu().numpy()
                    for k, v in state.log_vars.items()})
        np.savez(os.path.join(tmp_dir, "opt_state.npz"), **_opt_flat(state))
        np.savez(os.path.join(tmp_dir, "best_params.npz"), **best_params)
        with open(os.path.join(tmp_dir, "meta.json"), "w") as f:
            json.dump({"epoch": epoch, "best_epoch": best_epoch,
                       "best_epoch_val_metrics": best_epoch_val_metrics,
                       "save_val_metrics": self.save_val_metrics,
                       "step": int(state.step)}, f)
        if os.path.exists(ckpt_dir):
            shutil.rmtree(ckpt_dir)
        os.replace(tmp_dir, ckpt_dir)
        return ckpt_dir

    @torch.no_grad()
    def restore(self, state: TrainState, tag: str = "latest"
                ) -> Tuple[TrainState, dict, dict]:
        """Load ``<dir>/<tag>`` into ``state`` in place: (state,
        best_params, meta). A checkpoint the JAX package wrote restores its
        weights, BN statistics and log-variances; its optimizer state
        (optax's names) is not read, and Adam starts afresh at its step."""
        ckpt_dir = os.path.join(self.directory, tag)
        with open(os.path.join(ckpt_dir, "meta.json")) as f:
            meta = json.load(f)

        def load(name):
            with np.load(os.path.join(ckpt_dir, name)) as z:
                return {k: z[k] for k in z.files}

        params, stats = load("params.npz"), load("batch_stats.npz")
        sd = regressor_state_dict_from_flat(
            {**_prefix(params, "params"), **_prefix(stats, "batch_stats")})
        missing, unexpected = state.regressor.load_state_dict(sd,
                                                              strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise ValueError("checkpoint %s does not fit the regressor: "
                             "missing %s, unexpected %s"
                             % (ckpt_dir, missing[:5], unexpected[:5]))
        for k, v in load("log_vars.npz").items():
            state.log_vars[k].copy_(torch.from_numpy(v))
        opt = load("opt_state.npz")
        if "count" in opt:
            for which, moments in (("mu", state.opt.mu),
                                   ("nu", state.opt.nu)):
                for key, m in zip(_opt_keys(state), moments):
                    a = opt["%s/%s" % (which, key)]
                    if key.endswith("/kernel"):
                        a = from_flax_layout(a)
                    m.copy_(torch.from_numpy(np.ascontiguousarray(a))
                            .reshape(m.shape))
            state.opt.count = int(opt["count"])
        state.step = int(meta["step"])
        return state, load("best_params.npz"), meta

