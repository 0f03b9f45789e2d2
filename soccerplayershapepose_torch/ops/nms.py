"""Box IoU, greedy non-maximum suppression and the person filter.

Counterpart of ``soccerplayershapepose_tpu/ops/nms.py``, in plain PyTorch
(torchvision is not a dependency). Shapes are static: :func:`nms` is a
fixed loop of ``max_outputs`` steps of argmax and IoU suppression over a
batch of box sets at once (the JAX package ``vmap``s its single-set
version), returning padded indices and a validity mask. Ties break as in
JAX: ``torch.argmax`` takes the first maximal index, as ``jnp.argmax``
does, and the person filter sorts with ``stable=True``, as ``jnp.argsort``
does.
"""

from __future__ import annotations

from typing import Optional

import torch


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU. a: (..., N, 4), b: (..., M, 4) [x1, y1, x2, y2] →
    (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]))[..., :, None]
    area_b = ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]))[..., None, :]
    return inter / torch.clamp(area_a + area_b - inter, min=1e-9)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
        max_outputs: Optional[int] = None):
    """Greedy NMS with a static output size.

    ``boxes`` (..., N, 4) [x1, y1, x2, y2], ``scores`` (..., N); the
    leading axes are independent sets. Returns ``(indices (..., K) int64,
    valid (..., K) bool)``: indices into each set in score order, invalid
    slots padded with 0; K = ``max_outputs`` (default N). Each step takes
    the best live box (the first of equal scores), keeps it and kills the
    boxes whose IoU with it exceeds the threshold.
    """
    lead = boxes.shape[:-2]
    n = boxes.shape[-2]
    k = max_outputs or n
    boxes = boxes.reshape(-1, n, 4)
    scores = scores.reshape(-1, n)
    s = boxes.shape[0]
    dev = boxes.device
    iou = box_iou(boxes, boxes)                               # (S, N, N)
    rows = torch.arange(s, device=dev)
    alive = torch.ones((s, n), dtype=torch.bool, device=dev)
    keep_idx = torch.zeros((s, k), dtype=torch.int64, device=dev)
    keep_valid = torch.zeros((s, k), dtype=torch.bool, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=dev)
    for i in range(k):
        masked = torch.where(alive, scores, neg_inf)
        best = torch.argmax(masked, dim=-1)                   # (S,)
        valid = masked[rows, best] > float("-inf")
        keep_idx[:, i] = torch.where(valid, best, 0)
        keep_valid[:, i] = valid
        suppress = iou[rows, best] > iou_threshold            # (S, N)
        alive = alive & ~suppress & valid[:, None]
        alive[rows, best] = False
    return keep_idx.reshape(lead + (k,)), keep_valid.reshape(lead + (k,))


def filter_person_detections(boxes: torch.Tensor, scores: torch.Tensor,
                             labels: torch.Tensor, score_thresh: float = 0.7,
                             person_label: int = 1, max_outputs: int = 32):
    """Person-class detections at or above ``score_thresh``, score-ordered
    (a stable sort: equal scores keep their input order) and padded to
    ``max_outputs``: ``(boxes (K, 4), zero on invalid slots; valid (K,)
    bool)``."""
    ok = (scores >= score_thresh) & (labels == person_label)
    masked = torch.where(ok, scores, torch.full_like(scores, float("-inf")))
    order = torch.argsort(-masked, stable=True)[:max_outputs]
    valid = masked[order] > float("-inf")
    return boxes[order] * valid[:, None], valid
