"""Silhouette and segmentation label ops and pixel metrics.

Counterpart of ``soccerplayershapepose_tpu/ops/segmentation.py``:

* confusion metrics round their inputs (half to even, as ``jnp.round``) to
  booleans; IoU is the exact ``tp / (tp + fp + fn)`` with no epsilon, the
  others carry 1e-9;
* the DensePose 24-part → 6-part LSP label map (the label space of the
  part-segmentation render) and the non-zero → 1 binary mask;
* the mean L2 pixel error of 2-D joints.
"""

from __future__ import annotations

import torch

# DensePose part id (1..24) → LSP 6-part id; index 0 stays background.
_DP_TO_LSP = (0, 6, 6, 2, 1, 4, 5, 5, 4, 5, 4, 5, 4, 5, 4, 1, 2, 1, 2, 1, 2,
              1, 2, 3, 3)


def densepose_to_6part_lsp(densepose_seg: torch.Tensor) -> torch.Tensor:
    """Map 24-part DensePose labels to the 6-part LSP convention (int32)."""
    table = torch.tensor(_DP_TO_LSP, dtype=torch.int32,
                         device=densepose_seg.device)
    return table[densepose_seg.to(torch.long)]


def multiclass_to_binary(labels: torch.Tensor) -> torch.Tensor:
    """Multiclass segmentation → binary mask (non-zero → 1), same dtype."""
    return (labels != 0).to(labels.dtype)


def joints2d_l2_error(pred: torch.Tensor, target: torch.Tensor,
                      mean_axes=None) -> torch.Tensor:
    """Mean L2 pixel error of (..., N, 2) joints, over ``mean_axes``
    (default all: a 0-dim tensor)."""
    err = torch.linalg.vector_norm(pred - target, dim=-1)
    if mean_axes is None:
        return err.mean()
    return err.mean(dim=mean_axes)


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
