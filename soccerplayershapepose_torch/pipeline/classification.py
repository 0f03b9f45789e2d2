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
loads in both (``weights/frame_classifier.npz`` is one).

:func:`train_classifier` trains the head as the JAX package does: Adam
(``train/optim.py``) over precomputed (N, 1000) features in shuffled
mini-batches, the validation split and every epoch's order drawn from one
``np.random.RandomState(seed)``, so both packages visit the same rows.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from soccerplayershapepose_torch.models.classifier import ClassifyNet
from soccerplayershapepose_torch.models.init import flax_init_
from soccerplayershapepose_torch.models.resnet import resnet18
from soccerplayershapepose_torch.train.optim import Adam
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


def train_classifier(features: np.ndarray, labels: np.ndarray,
                     epochs: int = 10, lr: float = 2e-4,
                     batch_size: int = 64, seed: int = 0,
                     val_split: float = 0.1,
                     head: Optional[ClassifyNet] = None,
                     device: DeviceLike = None
                     ) -> Tuple[ClassifyNet, dict]:
    """Train the head on (N, 1000) features and (N,) int labels on
    ``device`` (None: the CUDA card).

    ``RandomState(seed)`` permutes the rows once: the first
    ``max(1, int(N · val_split))`` are the validation set, and the rest are
    shuffled again at each epoch and cut into ``batch_size`` mini-batches,
    one Adam step (``lr``) on the mean cross-entropy each. The head starts
    from ``head`` (moved to the device and trained in place) or from flax's
    initialisers drawn with a CPU generator seeded ``seed``. Returns the
    head in eval mode and ``{"train_loss", "val_acc"}``, one entry per
    epoch.
    """
    dev = default_device(device)
    rng = np.random.RandomState(seed)
    n = len(features)
    order = rng.permutation(n)
    n_val = max(1, int(n * val_split))
    val_idx, train_idx = order[:n_val], order[n_val:]
    if head is None:
        head = flax_init_(ClassifyNet(), torch.Generator().manual_seed(seed))
    head = head.to(dev).train()
    opt = Adam(list(head.parameters()), lr)
    feats = torch.as_tensor(np.asarray(features, np.float32), device=dev)
    labs = torch.as_tensor(np.asarray(labels, np.int64), device=dev)
    val = torch.as_tensor(val_idx, device=dev)
    history = {"train_loss": [], "val_acc": []}
    for _ in range(epochs):
        rng.shuffle(train_idx)
        losses = []
        for i in range(0, len(train_idx), batch_size):
            idx = torch.as_tensor(train_idx[i:i + batch_size], device=dev)
            loss = F.cross_entropy(head(feats[idx]), labs[idx])
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        history["train_loss"].append(float(np.mean(losses)))
        with torch.no_grad():
            pred = torch.argmax(head(feats[val]), dim=-1)
            history["val_acc"].append(float(
                (pred == labs[val]).to(torch.float32).mean()))
    return head.eval(), history
