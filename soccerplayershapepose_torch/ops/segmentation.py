"""Confusion-based silhouette metrics.

Counterpart of ``soccerplayershapepose_tpu/ops/segmentation.py``: inputs are
rounded (half to even, as ``jnp.round``) to booleans; IoU is the exact
``tp / (tp + fp + fn)`` with no epsilon, the others carry 1e-9.
"""

from __future__ import annotations

import torch


def silhouette_confusion_metrics(pred: torch.Tensor,
                                 target: torch.Tensor) -> dict:
    """(..., H, W) silhouettes → dict of (...) global_acc, iou, f1,
    precision and recall."""
    p = torch.round(pred.float()) > 0.5
    t = torch.round(target.float()) > 0.5
    axes = (-2, -1)
    tp = torch.sum(p & t, dim=axes).float()
    fp = torch.sum(p & ~t, dim=axes).float()
    tn = torch.sum(~p & ~t, dim=axes).float()
    fn = torch.sum(~p & t, dim=axes).float()

    global_acc = (tp + tn) / (tp + tn + fp + fn)
    iou = tp / (tp + fp + fn)
    precision = tp / (tp + fp + 1e-9)
    recall = tp / (tp + fn + 1e-9)
    f1 = (2.0 * precision * recall) / (precision + recall + 1e-9)
    return {"global_acc": global_acc, "iou": iou, "f1": f1,
            "precision": precision, "recall": recall}
