"""Crop → SMPL mesh prediction.

Counterpart of ``soccerplayershapepose_tpu/pipeline/predict.py``: proxy
representation → regressor (ResNet + IEF) → 6D → rotation matrices → SMPL
→ weak-perspective joint projection → perspective camera translation, plus
the T-pose vertices from the shape. The regressor's convolutions and
matrix products go to cuDNN and cuBLAS through PyTorch (in fp32: TF32 is
off, ``utils/precision.py``); this stage has no kernel of its own.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.models.ief import default_initial_params
from soccerplayershapepose_torch.models.regressor import SingleInputRegressor
from soccerplayershapepose_torch.ops.camera import (
    orthographic_project, undo_keypoint_normalisation,
    weak_perspective_to_translation)
from soccerplayershapepose_torch.ops.rotations import rot6d_to_rotmat
from soccerplayershapepose_torch.pipeline.proxy import (
    create_proxy_representation)
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.smpl.model import (
    smpl_forward, smpl_shape_only)
from soccerplayershapepose_torch.utils import profiling
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, as_f32, default_device)


class PredictOutput(NamedTuple):
    vertices: torch.Tensor          # (B, 6890, 3)
    joints: torch.Tensor            # (B, 90, 3)
    joints2d_kprcnn: torch.Tensor   # (B, 17, 2) projected KP-RCNN joints, px
    cam_wp: torch.Tensor            # (B, 3)
    translation: torch.Tensor       # (B, 3) perspective-camera translation
    pose_rotmats: torch.Tensor      # (B, 24, 3, 3)
    betas: torch.Tensor             # (B, 10)
    reposed_vertices: torch.Tensor  # (B, 6890, 3) T-pose from betas


def on_device(assets: SMPLAssets, device: torch.device) -> SMPLAssets:
    """``assets`` on ``device``, copied only if they lie elsewhere."""
    return assets if assets.faces.device == device else assets.to(device)


@torch.no_grad()
def predict_smpl(regressor: SingleInputRegressor, assets: SMPLAssets,
                 silhouette, joints2d, iuv=None,
                 proxy_wh: int = cfg.PROXY_REP_INPUT_WH,
                 device: DeviceLike = None) -> PredictOutput:
    """Batched crop → mesh forward pass on ``device`` (None: the CUDA card).

    ``silhouette`` (B, proxy_wh, proxy_wh), ``joints2d`` (B, 17, 2|3) in
    proxy_wh pixels, optional ``iuv`` (B, 3, proxy_wh, proxy_wh); numpy
    arrays or tensors. The regressor (moved to ``device``) runs in eval
    mode. The call is the span ``predict``, with ``predict.proxy``,
    ``predict.regressor`` and ``smpl.forward`` inside.
    """
    dev = default_device(device)
    assets = on_device(assets, dev)
    regressor = regressor.to(dev).eval()
    with profiling.span("predict"):
        with profiling.span("predict.proxy"):
            proxy = create_proxy_representation(
                as_f32(silhouette, dev), as_f32(joints2d, dev),
                in_wh=proxy_wh, out_wh=cfg.REGRESSOR_IMG_WH,
                iuv=None if iuv is None else as_f32(iuv, dev),
                include_silhouette=regressor.in_channels != 20)
        init = default_initial_params(assets.mean_pose_rot6d,
                                      assets.mean_shape)
        with profiling.span("predict.regressor"):
            cam_wp, pose6d, betas = regressor(proxy, init)

        rotmats = rot6d_to_rotmat(pose6d.reshape(-1, cfg.NUM_JOINTS, 6))
        out = smpl_forward(assets, betas, rotmats[:, 1:], rotmats[:, :1])
        j2d = orthographic_project(out.joints, cam_wp)[
            :, list(cfg.SMPL_TO_KPRCNN_MAP)]
        j2d = undo_keypoint_normalisation(j2d, proxy_wh)
        translation = weak_perspective_to_translation(
            cam_wp, cfg.FOCAL_LENGTH, proxy_wh)
        return PredictOutput(
            vertices=out.vertices, joints=out.joints, joints2d_kprcnn=j2d,
            cam_wp=cam_wp, translation=translation, pose_rotmats=rotmats,
            betas=betas, reposed_vertices=smpl_shape_only(assets, betas))


def build_predictor(in_channels: int = 18, resnet_layers: int = 18,
                    ief_iters: int = 3, seed: int = 0,
                    proxy_wh: int = cfg.PROXY_REP_INPUT_WH,
                    device: DeviceLike = None):
    """A regressor with random weights drawn from ``seed`` on ``device``
    (None: the CUDA card), and ``fn(assets, silhouette, joints2d)`` →
    :class:`PredictOutput` through it. The committed weights load with
    ``convert.load_regressor_weights`` instead."""
    dev = default_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        regressor = SingleInputRegressor(in_channels=in_channels,
                                         resnet_layers=resnet_layers,
                                         ief_iters=ief_iters)
    regressor = regressor.to(dev).eval()

    def fn(assets: SMPLAssets, silhouette, joints2d) -> PredictOutput:
        return predict_smpl(regressor, assets, silhouette, joints2d,
                            proxy_wh=proxy_wh, device=dev)

    return regressor, fn
