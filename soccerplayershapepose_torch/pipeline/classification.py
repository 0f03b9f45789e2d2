"""Main-camera frame classification: the gate of the video harvest.

Counterpart of the inference half of
``soccerplayershapepose_tpu/pipeline/classification.py``: a frame is
resized so its short side is 256 (nearest index), centre-cropped to 224²
(:func:`preprocess_frame`), run through :class:`FrameFeatureNet` (ImageNet
normalisation, a ResNet-18 trunk, a 512 → 1000 linear layer) and then
:class:`models.classifier.ClassifyNet`; class 1 (the argmax) is a
main-camera shot. :class:`Classifier` does this one frame at a time, as the
JAX package's does, on its device (None: the CUDA card).

A bundle (:func:`save_classifier`, :func:`load_classifier`) is a flat npz in
the JAX package's key layout (``head/params/Dense_k/...``, and optionally
``features/params/ResNet_0/...``, ``features/batch_stats/...``,
``features/params/Dense_0/...``), so a bundle written by either package
loads in both (``weights/frame_classifier.npz`` is one). Training the head
(``train_classifier``) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from soccerplayershapepose_torch.models.classifier import ClassifyNet
from soccerplayershapepose_torch.models.resnet import resnet18
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, default_device)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class FrameFeatureNet(nn.Module):
    """(B, H, W, 3) float frames in [0, 1] → (B, 1000) logits: ImageNet
    normalisation, the ResNet-18 trunk (``encoder``, pooled 512-d) and a
    512 → 1000 linear layer (``fc``)."""

    def __init__(self):
        super().__init__()
        self.encoder = resnet18(3)
        self.fc = nn.Linear(self.encoder.out_features, 1000)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = (images.to(torch.float32) - self.mean) / self.std
        return self.fc(self.encoder(x.permute(0, 3, 1, 2)))


def preprocess_frame(frame_u8: np.ndarray, out_wh: int = 224) -> np.ndarray:
    """Frame → (224, 224, 3) float32 classifier input in [0, 1]: resized
    (nearest index at the pixel centres) so the short side is 256, then
    centre-cropped to ``out_wh``²."""
    h, w = frame_u8.shape[:2]
    scale = 256.0 / min(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    ys = (np.arange(nh) + 0.5) * (h / nh) - 0.5
    xs = (np.arange(nw) + 0.5) * (w / nw) - 0.5
    yi = np.clip(np.round(ys).astype(int), 0, h - 1)
    xi = np.clip(np.round(xs).astype(int), 0, w - 1)
    resized = frame_u8[yi][:, xi]
    y0, x0 = (nh - out_wh) // 2, (nw - out_wh) // 2
    crop = resized[y0:y0 + out_wh, x0:x0 + out_wh]
    return crop.astype(np.float32) / 255.0


class Classifier:
    """The frame gate: is this frame a main-camera shot?

    ``head`` runs on ``device`` (None: the CUDA card); ``feature_fn`` maps
    a frame to its (1000,) features (:func:`make_frame_classifier` builds
    it); without one the gate takes precomputed feature vectors only.
    """

    def __init__(self, head: ClassifyNet,
                 feature_fn: Optional[Callable[[np.ndarray], np.ndarray]]
                 = None, device: DeviceLike = None):
        self.device = default_device(device)
        self.net = head.to(self.device).eval()
        self.feature_fn = feature_fn

    @torch.no_grad()
    def logits(self, image_or_features) -> np.ndarray:
        """A frame (H, W, 3) uint8 or a (1000,) feature vector → the (2,)
        class logits."""
        feats = np.asarray(image_or_features)
        if feats.ndim != 1 and self.feature_fn is not None:
            feats = self.feature_fn(feats)
        x = torch.as_tensor(np.asarray(feats, np.float32)[None],
                            device=self.device)
        return self.net(x)[0].cpu().numpy()

    def process(self, image_or_features) -> bool:
        return bool(int(np.argmax(self.logits(image_or_features))) == 1)

    __call__ = process      # usable directly as a harvest-stage gate


def make_frame_classifier(head: ClassifyNet,
                          features: Optional[FrameFeatureNet] = None,
                          device: DeviceLike = None) -> Classifier:
    """The full gate: frame → :func:`preprocess_frame` → ``features`` on
    the device → ``head``. Without ``features`` the gate takes precomputed
    (1000,) feature vectors only."""
    dev = default_device(device)
    if features is None:
        return Classifier(head, device=dev)
    features = features.to(dev).eval()

    @torch.no_grad()
    def feature_fn(frame_u8: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(preprocess_frame(np.asarray(frame_u8))[None])
        return features(x.to(dev))[0].cpu().numpy()

    return Classifier(head, feature_fn=feature_fn, device=dev)


def save_classifier(path: str, head: ClassifyNet,
                    features: Optional[FrameFeatureNet] = None) -> None:
    """Write ``head`` (and ``features``) as a flat npz in the JAX
    package's key layout."""
    from soccerplayershapepose_torch.convert import classifier_flat_from_modules
    np.savez(path, **classifier_flat_from_modules(head, features))


def load_classifier(path: str, device: DeviceLike = None) -> Classifier:
    """Load a :func:`save_classifier` bundle (of either package) into a
    ready frame gate on ``device``; the load is strict."""
    from soccerplayershapepose_torch.convert import load_classifier_weights
    head, features = load_classifier_weights(path, device)
    return make_frame_classifier(head, features, device)
