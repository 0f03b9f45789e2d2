"""Full-frame pipeline: frames → detections → crops → proxies → SMPL meshes.

Counterpart of ``soccerplayershapepose_tpu/pipeline/fullframe.py``
(BASELINE config 3): one call per batch of frames runs

1. the detector and its static top-K decode (``models/detector.py``),
   K = ``max_players``;
2. a square crop of each box, grown by ``border`` and squared on its longer
   side, resized by bilinear ROI sampling (``ops/roi_align.py``, one sample
   per output pixel), off-frame regions clamped to the frame's edge;
3. ProxyNet and the keypoint and silhouette decoders
   (``models/perception.py``);
4. the proxy representation → ResNet + IEF regressor → SMPL
   (``pipeline/predict.py``).

Shapes are static: every one of the K slots is computed, and ``valid``
(score ≥ ``score_thresh``) says which hold a player. Everything runs on
one device in fp32 with TF32 off (``utils/precision.py``); the JAX
package's bench runs this path in bf16 on random weights, the port on the
committed weights in fp32. This path launches no hand-written kernel: its
convolutions and matrix products are cuDNN and cuBLAS calls.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.models.detector import (
    PlayerDetector, decode_detections)
from soccerplayershapepose_torch.models.perception import (
    ProxyNet, decode_keypoints, decode_silhouette)
from soccerplayershapepose_torch.models.regressor import SingleInputRegressor
from soccerplayershapepose_torch.ops.roi_align import roi_align
from soccerplayershapepose_torch.pipeline.predict import (
    on_device, predict_smpl)
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.utils import profiling
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, as_f32, default_device)


class FramePipelineOutput(NamedTuple):
    vertices: torch.Tensor      # (F, K, 6890, 3)
    joints2d: torch.Tensor      # (F, K, 17, 2) in crop pixel space
    pose_rotmats: torch.Tensor  # (F, K, 24, 3, 3)
    betas: torch.Tensor         # (F, K, 10)
    cam_wp: torch.Tensor        # (F, K, 3)
    boxes: torch.Tensor         # (F, K, 4) square crop boxes, frame px
    scores: torch.Tensor        # (F, K) detector scores
    valid: torch.Tensor         # (F, K) score ≥ thresh


def _square_boxes(boxes: torch.Tensor, border: float) -> torch.Tensor:
    """Grow by ``border`` and square on the longer side (at least 8 px),
    about the box's centre."""
    cx = (boxes[..., 0] + boxes[..., 2]) / 2
    cy = (boxes[..., 1] + boxes[..., 3]) / 2
    side = torch.maximum(boxes[..., 2] - boxes[..., 0],
                         boxes[..., 3] - boxes[..., 1]) + 2 * border
    side = torch.clamp(side, min=8.0)
    return torch.stack([cx - side / 2, cy - side / 2,
                        cx + side / 2, cy + side / 2], dim=-1)


def build_frame_pipeline(detector: PlayerDetector, proxynet: ProxyNet,
                         regressor: SingleInputRegressor,
                         max_players: int = 22,
                         crop_wh: int = cfg.PROXY_REP_INPUT_WH,
                         score_thresh: float = cfg.DETECTION_SCORE_THRESH,
                         border: float = cfg.PLAYER_CROP_BORDER,
                         device: DeviceLike = None,
                         stage_times: Optional[dict] = None) -> Callable:
    """Returns ``fn(assets, frames) -> FramePipelineOutput``.

    The three nets move to ``device`` (None: the CUDA card) in eval mode.
    ``frames``: (F, H, W, 3) float in [0, 1] (numpy or tensor), H and W
    divisible by 32. With ``stage_times`` (a dict) each call synchronises
    the device after every stage and adds the stage's seconds under
    ``detect`` (the frame's copy, detector and decode), ``roi_align``,
    ``proxynet`` (ProxyNet and its decoders) and ``predict``; without it
    nothing waits. A call is the span ``frame``, each stage the span
    ``frame.<stage>``, with ``frame.decode`` (``decode_detections`` and
    the square boxes) and ``frame.proxy_decode`` inside; the counters
    ``frame.slots`` and ``frame.valid_slots`` add the F × K slots computed
    and those holding a player (``utils/profiling.py``).
    """
    dev = default_device(device)
    detector = detector.to(dev).eval()
    proxynet = proxynet.to(dev).eval()
    regressor = regressor.to(dev).eval()
    k = max_players

    stage = profiling.Stages(stage_times, dev, prefix="frame.")

    @torch.no_grad()
    def fn(assets: SMPLAssets, frames) -> FramePipelineOutput:
        with profiling.span("frame"):
            with stage("detect"):
                frames = as_f32(frames, dev)
                f = frames.shape[0]
                out = detector(frames.permute(0, 3, 1, 2))
                with profiling.span("frame.decode"):
                    dets = decode_detections(out, top_k=k)
                    sq = _square_boxes(dets.boxes, border)    # (F, K, 4)
            with stage("roi_align"):
                crops = roi_align(frames, sq, output_size=crop_wh,
                                  sampling_ratio=1)
                crops = crops.reshape(f * k, crop_wh, crop_wh, 3)
            with stage("proxynet"):
                p_out = proxynet(crops.permute(0, 3, 1, 2))
                with profiling.span("frame.proxy_decode"):
                    sil = decode_silhouette(p_out.mask_logits)  # (FK, c, c)
                    kps = decode_keypoints(
                        p_out.kp_logits,
                        stride=crop_wh // p_out.kp_logits.shape[1])
            with stage("predict"):
                pred = predict_smpl(regressor, on_device(assets, dev), sil,
                                    kps, proxy_wh=crop_wh, device=dev)
            valid = dets.scores >= score_thresh
            profiling.count("frame.slots", f * k)
            profiling.count("frame.valid_slots", valid)
        return FramePipelineOutput(
            vertices=pred.vertices.reshape(f, k, -1, 3),
            joints2d=pred.joints2d_kprcnn.reshape(f, k, 17, 2),
            pose_rotmats=pred.pose_rotmats.reshape(f, k, 24, 3, 3),
            betas=pred.betas.reshape(f, k, 10),
            cam_wp=pred.cam_wp.reshape(f, k, 3),
            boxes=sq, scores=dets.scores, valid=valid)

    return fn
