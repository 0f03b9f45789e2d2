"""Carry state from numpy into the port.

The JAX package's ``SMPLAssets`` turned into numpy
(``{k: np.asarray(v) for k, v in dataclasses.asdict(assets).items()}``) and
a fit's initial parameters become the port's tensors, so both packages can
compute on the same numbers. The committed flax regressor weights
(``weights/*.npz``, flat keys as ``train/checkpoint.py:_flatten`` writes
them) load into :class:`SingleInputRegressor`, the committed ProxyNet
weights (``weights/proxynet_*_f16.npz``) into :class:`ProxyNet` and the
detector's (``weights/detector_256x448_f16.npz``) into
:class:`PlayerDetector` at run time. Nothing is written to disk.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.fit.engine import FitInit
from soccerplayershapepose_torch.models.detector import PlayerDetector
from soccerplayershapepose_torch.models.perception import ProxyNet
from soccerplayershapepose_torch.models.regressor import SingleInputRegressor
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, as_f32, default_device)

# flax leaf name → PyTorch parameter or buffer name
_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
           "mean": "running_mean", "var": "running_var"}
_FLAT_KEY = re.compile(r"^(params|batch_stats)/(\w+)/(.+)/(\w+)$")


def assets_from_numpy(d: dict, device="cpu") -> SMPLAssets:
    """dict of numpy arrays keyed like ``SMPLAssets`` → the port's assets.
    A ``parents`` entry, if present, gives the kinematic tree."""
    parents = d.get("parents", cfg.SMPL_PARENTS)
    arrays = {k: np.asarray(v) for k, v in d.items() if k != "parents"}
    return SMPLAssets.from_numpy(arrays, parents=tuple(parents), device=device)


def fit_init_from_numpy(body_pose, global_orient, betas, cam_wp,
                        device="cpu") -> FitInit:
    """(B, 23, 3, 3), (B, 1, 3, 3), (B, 10), (B, 3) arrays → ``FitInit``."""
    return FitInit(*(as_f32(np.asarray(x), device)
                     for x in (body_pose, global_orient, betas, cam_wp)))


def _module_name(top: str, path: list) -> str:
    """flax module path under ``ResNet_0`` / ``IEFModule_0`` → the
    :class:`SingleInputRegressor` submodule that holds it."""
    if top == "IEFModule_0" and len(path) == 1:
        return "ief.fcs.%d" % int(path[0].split("_")[1])      # Dense_k
    if top == "ResNet_0" and len(path) == 1:
        return {"Conv_0": "encoder.conv", "BatchNorm_0": "encoder.norm"}[
            path[0]]
    if top == "ResNet_0" and len(path) == 2:
        block = int(path[0].rsplit("_", 1)[1])   # BasicBlock_i, Bottleneck_i
        kind, j = path[1].rsplit("_", 1)
        return "encoder.blocks.%d.%s.%d" % (
            block, {"Conv": "convs", "BatchNorm": "norms"}[kind], int(j))
    raise KeyError("/".join([top] + path))


def regressor_state_dict_from_flat(flat: dict) -> dict:
    """Flat flax variables (``params/ResNet_0/Conv_0/kernel``,
    ``batch_stats/ResNet_0/BatchNorm_0/mean``, …) → a
    :class:`SingleInputRegressor` state dict: conv kernels HWIO → OIHW,
    dense kernels (in, out) → (out, in), BN scale/bias/mean/var →
    weight/bias/running_mean/running_var, everything cast to fp32."""
    sd = {}
    for key, arr in flat.items():
        m = _FLAT_KEY.match(key)
        if m is None:
            raise KeyError("not a flat flax variable name: %r" % key)
        _, top, path, leaf = m.groups()
        a = np.asarray(arr, np.float32)
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        name = "%s.%s" % (_module_name(top, path.split("/")), _LEAVES[leaf])
        sd[name] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def _load_strict(model, sd: dict, path: str, what: str):
    """Load ``sd`` into ``model``; a missing or an unexpected variable
    raises (BN's ``num_batches_tracked`` is not in flax's variables)."""
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError("weights %s do not fit %s: missing %s, unexpected %s"
                         % (path, what, missing[:5], unexpected[:5]))
    return model


def _read_flat(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def load_regressor_weights(path: str, device: DeviceLike = None
                           ) -> SingleInputRegressor:
    """Read a committed flax regressor npz → the regressor in eval mode on
    ``device`` (None: the CUDA card). The input width and depth are read
    from the weights (stem kernel's input channels; ``Bottleneck`` blocks
    mean ResNet-50); IEF runs 3 iterations."""
    dev = default_device(device)
    flat = _read_flat(path)
    in_channels = int(flat["params/ResNet_0/Conv_0/kernel"].shape[2])
    layers = 50 if any("/Bottleneck_" in k for k in flat) else 18
    model = SingleInputRegressor(in_channels=in_channels,
                                 resnet_layers=layers)
    _load_strict(model, regressor_state_dict_from_flat(flat), path,
                 "the regressor")
    return model.to(dev).eval()


def _proxynet_module_name(top: str, path: list) -> str:
    """flax module path of a :class:`ProxyNet` or :class:`PlayerDetector`
    variable → the submodule that holds it
    (``FPNTrunk_0/trunk/BasicBlock_3/Conv_1`` →
    ``trunk.trunk.blocks.3.convs.1``, ``kp_tower/Conv_0`` →
    ``kp_tower.convs.0``, ``FPNTrunk_0/fpn/lateral2`` →
    ``trunk.fpn.lateral.2``, ``mask_up1`` → ``mask_up1``)."""
    if top == "FPNTrunk_0" and path[0] == "trunk":
        if len(path) == 2:
            return {"Conv_0": "trunk.trunk.conv",
                    "BatchNorm_0": "trunk.trunk.norm"}[path[1]]
        if len(path) == 3:
            block = int(path[1].rsplit("_", 1)[1])
            kind, j = path[2].rsplit("_", 1)
            return "trunk.trunk.blocks.%d.%s.%d" % (
                block, {"Conv": "convs", "BatchNorm": "norms"}[kind], int(j))
    if top == "FPNTrunk_0" and path[0] == "fpn" and len(path) == 2:
        m = re.fullmatch(r"(lateral|smooth)(\d+)", path[1])
        if m:
            return "trunk.fpn.%s.%d" % (m.group(1), int(m.group(2)))
    if top.endswith("_tower") and len(path) == 1:
        return "%s.convs.%d" % (top, int(path[0].split("_")[1]))
    raise KeyError("/".join([top] + path))


def proxynet_state_dict_from_flat(flat: dict) -> dict:
    """Flat flax ProxyNet variables (``params/FPNTrunk_0/trunk/Conv_0/
    kernel``, ``params/kp_out/bias``, ``batch_stats/.../mean``, …) → a
    :class:`ProxyNet` state dict, with the mapping of
    :func:`regressor_state_dict_from_flat` (HWIO → OIHW, BN names),
    float16 cast to fp32 as flax promotes it against fp32 images."""
    sd = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if len(parts) < 3 or parts[0] not in ("params", "batch_stats") \
                or parts[-1] not in _LEAVES:
            raise KeyError("not a flat flax variable name: %r" % key)
        top, path, leaf = parts[1], parts[2:-1], parts[-1]
        name = top if not path else _proxynet_module_name(top, path)
        a = np.asarray(arr, np.float32)
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1)
        sd["%s.%s" % (name, _LEAVES[leaf])] = torch.from_numpy(
            np.ascontiguousarray(a))
    return sd


# ProxyNet's IUV head, which the 18-channel proxy does not use.
IUV_HEAD = ("iuv_tower", "part_out", "uv_out")


def load_proxynet_weights(path: str, device: DeviceLike = None,
                          with_iuv: Optional[bool] = None) -> ProxyNet:
    """Read a committed flax ProxyNet npz → the net in eval mode on
    ``device`` (None: the CUDA card). The head width is read from the
    weights, and ``with_iuv`` too unless given: ``with_iuv=False`` drops
    the IUV head's variables (``IUV_HEAD``) by name, as the full-frame
    pipeline builds ProxyNet. The load is strict: a missing or an
    unexpected variable raises."""
    dev = default_device(device)
    flat = _read_flat(path)
    if with_iuv is None:
        with_iuv = "params/part_out/kernel" in flat
    if not with_iuv:
        flat = {k: v for k, v in flat.items()
                if k.split("/")[1] not in IUV_HEAD}
    channels = int(flat["params/kp_out/kernel"].shape[2])
    model = ProxyNet(with_iuv=with_iuv, channels=channels)
    _load_strict(model, proxynet_state_dict_from_flat(flat), path, "ProxyNet")
    return model.to(dev).eval()


def detector_state_dict_from_flat(flat: dict) -> dict:
    """Flat flax PlayerDetector variables (``params/FPNTrunk_0/...``,
    ``params/det_tower/Conv_{0,1}``, ``params/{center,size,offset}_out``,
    ``batch_stats/...``) → a :class:`PlayerDetector` state dict, with
    ProxyNet's mapping (the trunk's names are the same)."""
    return proxynet_state_dict_from_flat(flat)


def load_detector_weights(path: str, device: DeviceLike = None
                          ) -> PlayerDetector:
    """Read a committed flax detector npz (``weights/detector_256x448_f16
    .npz``) → the detector in eval mode on ``device`` (None: the CUDA
    card). The width is read from the weights; the load is strict."""
    dev = default_device(device)
    flat = _read_flat(path)
    channels = int(flat["params/center_out/kernel"].shape[2])
    model = PlayerDetector(channels=channels)
    _load_strict(model, detector_state_dict_from_flat(flat), path,
                 "PlayerDetector")
    return model.to(dev).eval()
