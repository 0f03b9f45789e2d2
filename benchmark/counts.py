"""Peaks of the card and the work of a call, counted from shapes.

The peaks are NVIDIA's published figures for one H100 SXM: 67 TFLOP/s in
float32 outside the tensor cores (the configurations compute in float32
with TF32 off) and 3.35 TB/s of HBM3, at the full 700 W power limit.

The soft-silhouette rasterizers' work is the (face, pixel) pairs their
inputs need: for every front face (the 60% of largest signed area), the
pixel centres in its bounding box padded by √(20.1·σ_px), beyond which
its coverage is below 2e-9. A pair costs the forward 73 and the backward
93 floating-point operations (the three edge functions, clamped
projections and squared distances, the sign, the sigmoid and the log of
the forward; the same again with the chain rule through the nearest
edge for the backward). The count is of the work, whatever computes it.
"""

from __future__ import annotations

import torch

from benchmark import pairs
from benchmark.reference import smpl

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_S = 3.35e12
SIL_FWD_OPS_PER_PAIR = 73
SIL_BWD_OPS_PER_PAIR = 93
SUPPORT_D2 = 20.1
# Floats a rasterizer reads per face: three vertices, three edges, three
# reciprocal squared lengths, a flag, a padded box.
FACE_RECORD_FLOATS = 20


def roofline_ms(ops: float, bytes_moved: float) -> float:
    """The least time the card could take, in ms: operations over the
    float32 peak or bytes over the memory rate, whichever is larger."""
    return max(ops / PEAK_FP32_FLOPS, bytes_moved / PEAK_HBM_BYTES_S) * 1e3


def support_pairs(verts2d: torch.Tensor, faces: torch.Tensor, wh: int,
                  sigma: float) -> int:
    """Pairs the silhouette of meshes (B, V, 2) in pixels needs at σ."""
    sigma_px = sigma * (wh / 2.0) ** 2
    tri = verts2d[:, faces]
    keep = pairs.front_faces(tri)
    boxes = pairs.face_boxes(tri[keep], (SUPPORT_D2 * sigma_px) ** 0.5)
    return pairs.count_pairs(boxes, wh)


def silhouette_bytes(rows: int, wh: int, backward: bool) -> float:
    """Bytes a rasterizer call must move, each read or written once: the
    front faces' records and the (rows, wh, wh) image out (forward), or
    the records, the image's gradient in and each face's six vertex
    gradients out (backward)."""
    faces = rows * int(smpl.NUM_FACES * 0.6)
    image = rows * wh * wh * 4.0
    rec = faces * FACE_RECORD_FLOATS * 4.0
    return rec + image + (faces * 6 * 4.0 if backward else 0.0)


def smpl_forward_flops(rows: int) -> float:
    """A forward pass of SMPL over ``rows`` bodies, as dense
    contractions: shape and pose blendshapes, the joint regressor, the
    blend of the 24 transforms and their application, the 45 regressed
    joints."""
    v3 = smpl.NUM_VERTS * 3
    per = 2.0 * (v3 * smpl.NUM_BETAS + 9 * smpl.NUM_BODY_JOINTS * v3
                 + smpl.NUM_JOINTS * v3 + smpl.NUM_VERTS * 24 * 12
                 + smpl.NUM_VERTS * 12 + (9 + 19 + 17) * v3)
    return rows * per
