"""Player pick and crop helpers of the detection stages.

Counterpart of ``soccerplayershapepose_tpu/pipeline/detection.py``, kept as
a copy so the port never imports the JAX package. The production detector
is :class:`models.detector.PlayerDetector`, run by
``pipeline/extract.py:PlayerDetectorRunner``; the helpers here pick and
crop players out of its boxes on the host:

* per view, the centre-most detection, grown by a border, squared with the
  field-green pad and resized to 512² (:func:`crop_player_view`);
* per broadcast frame, one such crop per box (:func:`crop_broadcast_players`);
* for keypoints, the largest roughly-centred box (:func:`largest_centred_box`).

:class:`TorchPersonDetector` is the optional interop with torchvision's
Faster-RCNN (or KP-RCNN) for users who bring their own weights. It needs
``torchvision``, imported when one is built; without it the constructor
raises ImportError, as the JAX package's does. Like every entry point of
the port it runs on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.pipeline.preprocess import (
    get_centre_object, square_crop_padded)
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, default_device)


class TorchPersonDetector:
    """torchvision's Faster-RCNN R50-FPN person detector on ``device``.

    Loads the state dict at ``weights_path`` when it exists (no download:
    without weights the net is randomly initialised, useful for shape
    tests only); ``keypoints=True`` builds KP-RCNN instead. ``device=None``
    means the CUDA card, as for every entry point of the port.
    """

    def __init__(self, weights_path: Optional[str] = None,
                 score_thresh: float = cfg.DETECTION_SCORE_THRESH,
                 keypoints: bool = False, device: DeviceLike = None):
        try:
            import torchvision
        except ImportError as e:
            raise ImportError(
                "TorchPersonDetector needs torchvision; use precomputed "
                "boxes/proxies interop (drivers.stages) instead") from e
        self.device = default_device(device)
        if keypoints:
            self.model = torchvision.models.detection.keypointrcnn_resnet50_fpn(
                weights=None, weights_backbone=None)
        else:
            self.model = torchvision.models.detection.fasterrcnn_resnet50_fpn(
                weights=None, weights_backbone=None)
        if weights_path and os.path.exists(weights_path):
            self.model.load_state_dict(torch.load(weights_path,
                                                  map_location=self.device))
        self.model.to(self.device).eval()
        self.score_thresh = score_thresh
        self.keypoints = keypoints

    def __call__(self, image_rgb: np.ndarray) -> dict:
        """(H, W, 3) uint8 → {'boxes' (N,4), 'scores' (N,), 'keypoints'?}."""
        with torch.no_grad():
            tensor = torch.from_numpy(
                image_rgb.astype(np.float32).transpose(2, 0, 1) / 255.0)
            out = self.model([tensor.to(self.device)])[0]
        person = (out["labels"] == 1) & (out["scores"] >= self.score_thresh)
        result = {"boxes": out["boxes"][person].cpu().numpy(),
                  "scores": out["scores"][person].cpu().numpy()}
        if self.keypoints:
            result["keypoints"] = out["keypoints"][person].cpu().numpy()
        return result


def select_centre_player(boxes: np.ndarray,
                         frame_hw: Tuple[int, int]) -> Optional[np.ndarray]:
    """The centre-most detection, or None when there is none."""
    if len(boxes) == 0:
        return None
    return boxes[get_centre_object(boxes, frame_hw)]


def largest_centred_box(boxes: np.ndarray, frame_hw: Tuple[int, int],
                        centre_tolerance: float = 0.25) -> Optional[int]:
    """Index of the largest box whose centre lies within
    ``centre_tolerance`` of the frame's size from its centre; the largest
    box overall when none does; None when there is no box."""
    if len(boxes) == 0:
        return None
    h, w = frame_hw
    cx = (boxes[:, 0] + boxes[:, 2]) / 2
    cy = (boxes[:, 1] + boxes[:, 3]) / 2
    centred = (np.abs(cx - w / 2) < w * centre_tolerance) & \
              (np.abs(cy - h / 2) < h * centre_tolerance)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    areas = np.where(centred, areas, -1.0)
    if areas.max() < 0:
        areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return int(np.argmax(areas))


def crop_player_view(image_rgb: np.ndarray, boxes: np.ndarray,
                     border: int = cfg.PLAYER_CROP_BORDER) -> Optional[np.ndarray]:
    """Per-view crop: the centre-most player → green-padded 512² crop."""
    box = select_centre_player(boxes, image_rgb.shape[:2])
    if box is None:
        return None
    return square_crop_padded(image_rgb, box, border=border)


def crop_broadcast_players(image_rgb: np.ndarray, boxes: np.ndarray,
                           border: int = cfg.PLAYER_CROP_BORDER_BROAD
                           ) -> List[np.ndarray]:
    """Broadcast frame: one 512² green-padded crop per player box."""
    return [square_crop_padded(image_rgb, box, border=border)
            for box in boxes]
