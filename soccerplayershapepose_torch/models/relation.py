"""Inter-player pose relation module (bbox-geometry-gated attention).

Counterpart of ``soccerplayershapepose_tpu/models/relation.py``: refine the
(24, 3, 3) pose rotmats of every player in a frame by attending across the
players, with an attention bias from their boxes' relative geometry:

* the pairwise geometry (|Δcx|/w, |Δcy|/h as logs, the log width and
  height ratios) goes through a sinusoidal embedding
  (:func:`bbox_positional_embedding`);
* all relation units run as one attention with a heads axis: for output
  player i, unit h weighs player j by ``softmax_j(k_i·q_j / √dk + log
  max(ReLU(W_G e_ij), 1e-6))`` and returns ``Σ_j w_ij v_j``; the units'
  outputs concatenate;
* v0 (27 units × 8, ``geo_dim`` 8) adds them to the flattened rotmats
  (216); v1 (``lift_dim`` 1024: a 216 → 1024 linear lift with no
  activation, 16 units × 64, ``geo_dim`` 64) adds them in the lifted
  space and projects back with ``proj_back``, whose output replaces the
  rotmats.

Frames are padded to N players with a validity mask: a padded player is
never attended to (its logits are the dtype's least value) and passes
through unchanged. The flax ``DenseGeneral`` kernels (in, heads, dk) are
the transposed weights of ``Linear(in, heads·dk)``
(``convert.load_relation_weights``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from soccerplayershapepose_torch import config as cfg


def bbox_positional_embedding(boxes: torch.Tensor, dim_g: int = 8,
                              wave_len: float = 1000.0) -> torch.Tensor:
    """Pairwise box-geometry embedding: boxes (..., N, 4) [x1, y1, x2, y2]
    → (..., N, N, dim_g) (``dim_g`` a multiple of 8), row i the output
    player, column j the attended one, the offsets normalised by row i's
    box size."""
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0

    def rel(c, s):
        d = c[..., :, None] - c[..., None, :]
        return torch.log(torch.clamp(torch.abs(d / s[..., :, None]),
                                     min=1e-3))

    pos = torch.stack([rel(cx, w), rel(cy, h),
                       torch.log(w[..., :, None] / w[..., None, :]),
                       torch.log(h[..., :, None] / h[..., None, :])],
                      dim=-1)                                  # (..., N, N, 4)
    n_freq = dim_g // 8
    feat_range = torch.arange(n_freq, dtype=torch.float32,
                              device=boxes.device) / n_freq
    inv_freq = 1.0 / torch.pow(torch.tensor(wave_len, device=boxes.device),
                               feat_range)
    angles = 100.0 * pos[..., None] * inv_freq               # (..., 4, nf)
    angles = angles.reshape(angles.shape[:-2] + (4 * n_freq,))
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


class PoseRelationModule(nn.Module):
    """Batched multi-head relation attention over the players of a frame."""

    def __init__(self, n_relations: int = 27, key_dim: int = 8,
                 geo_dim: int = 8, lift_dim: Optional[int] = None,
                 appearance_dim: int = cfg.NUM_JOINTS * 9):
        super().__init__()
        if lift_dim is not None and n_relations * key_dim != lift_dim:
            raise ValueError("lift_dim must equal n_relations·key_dim "
                             "(v1: 16·64 = 1024)")
        self.n_relations, self.key_dim = n_relations, key_dim
        self.geo_dim, self.lift_dim = geo_dim, lift_dim
        self.appearance_dim = appearance_dim
        width = appearance_dim if lift_dim is None else lift_dim
        hd = n_relations * key_dim
        if lift_dim is not None:
            self.lift = nn.Linear(appearance_dim, lift_dim)
            self.proj_back = nn.Linear(lift_dim, appearance_dim)
        self.WQ = nn.Linear(width, hd)
        self.WK = nn.Linear(width, hd)
        self.WV = nn.Linear(width, hd)
        self.WG = nn.Linear(geo_dim, n_relations)

    def forward(self, pose_rotmats: torch.Tensor, boxes: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, N, 24, 3, 3) rotmats, (B, N, 4) boxes in frame pixels and
        (B, N) bool mask (True for real players) → (B, N, 24, 3, 3) refined
        rotmats; padded players pass through unchanged."""
        b, n = pose_rotmats.shape[:2]
        h, dk = self.n_relations, self.key_dim
        f_a = pose_rotmats.reshape(b, n, self.appearance_dim)
        if mask is None:
            mask = torch.ones((b, n), dtype=torch.bool,
                              device=pose_rotmats.device)
        feats = f_a if self.lift_dim is None else self.lift(f_a)
        embed = bbox_positional_embedding(boxes, self.geo_dim)
        q = self.WQ(feats).reshape(b, n, h, dk)
        k = self.WK(feats).reshape(b, n, h, dk)
        v = self.WV(feats).reshape(b, n, h, dk)
        w_g = torch.relu(self.WG(embed))                      # (B, N, N, H)
        logits = torch.einsum("bihd,bjhd->bhij", k, q) / math.sqrt(dk)
        logits = logits + torch.log(torch.clamp(w_g, min=1e-6)).permute(
            0, 3, 1, 2)
        neg = torch.finfo(logits.dtype).min
        logits = torch.where(mask[:, None, None, :], logits, neg)
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(b, n, h * dk)
        if self.lift_dim is not None:
            refined = torch.where(mask[..., None],
                                  self.proj_back(out + feats), f_a)
        else:
            refined = torch.where(mask[..., None], out + f_a, f_a)
        return refined.reshape(b, n, cfg.NUM_JOINTS, 3, 3)
