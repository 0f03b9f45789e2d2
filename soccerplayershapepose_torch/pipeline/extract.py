"""Crop → (keypoints, silhouette, IUV): the proxy extraction of a real run.

Counterpart of ``ProxyExtractor`` and its helpers in
``soccerplayershapepose_tpu/pipeline/extract.py``. ProxyNet and its
decoders run on the extractor's device in one batched forward (the flipped
crops, with flip TTA, concatenated into the same forward at 2B); the
instance pick runs on the host, as in the JAX package: the largest
roughly-centred connected component of each decoded silhouette
(``scipy.ndimage``), the keypoint heatmaps boxed to that component's bbox
padded by 2 cells (−1e9 outside), then decoded.

With flip TTA the mask and IUV logits of the two passes are averaged (the
flipped pass un-mirrored: W flipped, left/right part channels swapped, the
U logit negated), and keypoints are merged per joint at the coordinate
level: averaged, score-weighted, where the two passes agree within
``kp_tta_tau`` of the crop size, the primary pass kept otherwise.

:class:`PlayerDetectorRunner` is the frame half: uint8 frames → the
detector (``models/detector.py``), with or without flip TTA → per-frame
boxes at or above the score threshold, on the host.

The stage functions of the JAX module (``create_proxy_stage``,
``crop_player_stage``, …) and ``read_image`` are not ported yet.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.models.detector import (
    PlayerDetector, apply_flip_tta, decode_detections)
from soccerplayershapepose_torch.models.perception import (
    ProxyNet, decode_iuv, decode_keypoints, decode_silhouette)
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, default_device)


def largest_centred_component(mask: np.ndarray) -> Optional[np.ndarray]:
    """Largest roughly-centred connected component of a binary mask: the
    components by decreasing area, the first whose bbox centre lies within
    w/4 rows and w/6 columns of the image centre; else the largest. Returns
    it as a {0, 1} float32 mask, or None if the mask is empty."""
    from scipy import ndimage
    labels, n = ndimage.label(mask > 0.5)
    if n == 0:
        return None
    h, w = mask.shape
    areas = ndimage.sum_labels(np.ones_like(mask), labels, range(1, n + 1))
    order = np.argsort(areas)[::-1]
    objects = ndimage.find_objects(labels)
    for idx in order:
        sl = objects[idx]
        cy = (sl[0].start + sl[0].stop - 1) / 2.0
        cx = (sl[1].start + sl[1].stop - 1) / 2.0
        if abs(cy - h / 2.0) < w / 4.0 and abs(cx - w / 2.0) < w / 6.0:
            return (labels == idx + 1).astype(np.float32)
    return (labels == order[0] + 1).astype(np.float32)


# COCO-17 keypoint left/right swap (nose fixed, each pair adjacent).
_KP_FLIP_PERM = (0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15)
# SMPL joint left/right swap (part id = dominant LBS joint).
_SMPL_FLIP_PERM = (0, 2, 1, 3, 5, 4, 6, 8, 7, 9, 11, 10, 12, 14, 13, 15,
                   17, 16, 19, 18, 21, 20, 23, 22)
# Part-logit channels are [bg] + 24 parts; UV channels are (u_p, v_p) pairs.
_PART_FLIP_PERM = (0,) + tuple(1 + j for j in _SMPL_FLIP_PERM)
_UV_FLIP_PERM = tuple(c for j in _SMPL_FLIP_PERM for c in (2 * j, 2 * j + 1))


def _flip_iuv_maps(part_logits: torch.Tensor, uv: torch.Tensor):
    """Un-mirror the channels-last stride-4 IUV maps of a flipped crop:
    flip W, swap left/right part channels, negate the U logit (a mirror
    maps the template pseudo-UV u to 1 − u)."""
    dev = part_logits.device
    part_f = part_logits.flip(2)[..., torch.tensor(_PART_FLIP_PERM,
                                                   device=dev)]
    uv_f = uv.flip(2)[..., torch.tensor(_UV_FLIP_PERM, device=dev)]
    sign = torch.tensor([-1.0, 1.0], dtype=uv.dtype,
                        device=dev).repeat(uv.shape[-1] // 2)
    return part_f, uv_f * sign


class ProxyExtractor:
    """Batched crop → host-side (keypoints, silhouette[, IUV]) per crop.

    ``model`` is moved to ``device`` (None: the CUDA card) and put in eval
    mode. ``flip_tta`` adds the mirrored pass; ``kp_tta_tau`` is the
    agreement radius of the keypoint merge as a fraction of the crop size,
    ``kp_disagree_penalty`` the score factor of a joint the passes place
    apart (1: unpenalised)."""

    def __init__(self, model: ProxyNet, wh: int = cfg.PROXY_REP_INPUT_WH,
                 flip_tta: bool = False, kp_tta_tau: float = 0.08,
                 kp_disagree_penalty: float = 1.0,
                 device: DeviceLike = None):
        self.device = default_device(device)
        self.model = model.to(self.device).eval()
        self.wh = wh
        self.flip_tta = flip_tta
        self.kp_tta_tau = kp_tta_tau
        self.kp_disagree_penalty = kp_disagree_penalty

    @torch.no_grad()
    def forward(self, images_u8) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                          torch.Tensor, Optional[torch.Tensor]]:
        """(B, wh, wh, 3) uint8 (numpy or tensor) → on the device:
        ``(kp_logits (B, h, w, 17), flipped pass's kp_logits un-mirrored or
        None, silhouette (B, wh, wh) {0, 1}, IUV (B, wh, wh, 3) or None)``.
        """
        images = torch.as_tensor(images_u8).to(self.device)
        images = images.permute(0, 3, 1, 2).to(torch.float32) / 255.0
        model = self.model
        kp_logits_flip = None
        if self.flip_tta:
            b = images.shape[0]
            out = model(torch.cat([images, images.flip(3)], 0))
            kp_logits = out.kp_logits[:b]
            kp_logits_flip = out.kp_logits[b:].flip(2)[
                ..., torch.tensor(_KP_FLIP_PERM, device=self.device)]
            mask_logits = 0.5 * (out.mask_logits[:b]
                                 + out.mask_logits[b:].flip(2))
            part_logits = uv = None
            if out.part_logits is not None:
                part_f, uv_f = _flip_iuv_maps(out.part_logits[b:], out.uv[b:])
                part_logits = 0.5 * (out.part_logits[:b] + part_f)
                uv = 0.5 * (out.uv[:b] + uv_f)
        else:
            out = model(images)
            kp_logits, mask_logits = out.kp_logits, out.mask_logits
            part_logits, uv = out.part_logits, out.uv
        sil = decode_silhouette(mask_logits)
        iuv = (decode_iuv(part_logits, uv, out_wh=images.shape[2])
               if model.with_iuv else None)
        return kp_logits, kp_logits_flip, sil, iuv

    def _merge_kp(self, kp: np.ndarray, kpf: np.ndarray,
                  crop_wh: int) -> np.ndarray:
        """Agreement-gated coordinate merge of primary/flipped decodes."""
        tau = self.kp_tta_tau * crop_wh
        d = np.hypot(kp[:, 0] - kpf[:, 0], kp[:, 1] - kpf[:, 1])
        agree = d <= tau
        w1, w2 = kp[:, 2], kpf[:, 2]
        wsum = w1 + w2 + 1e-8
        merged = np.stack([(w1 * kp[:, 0] + w2 * kpf[:, 0]) / wsum,
                           (w1 * kp[:, 1] + w2 * kpf[:, 1]) / wsum,
                           0.5 * (w1 + w2)], axis=-1)
        fallback = kp.copy()
        fallback[:, 2] *= self.kp_disagree_penalty
        return np.where(agree[:, None], merged, fallback)

    def __call__(self, images_u8) -> List[tuple]:
        """(B, wh, wh, 3) uint8 → one ``(keypoints (17, 3), silhouette
        (wh, wh), IUV (wh, wh, 3) | None)`` per crop, numpy on the host;
        ``(None, None, None)`` where no person was found."""
        return self.pick(*self.forward(images_u8))

    def pick(self, kp_dev, kpf_dev, sil_dev, iuv_dev) -> List[tuple]:
        """The host half of :meth:`__call__` on what :meth:`forward`
        returned: the instance pick, the boxed keypoint decode and the flip
        merge."""
        kp_logits = kp_dev.cpu().numpy()
        kp_logits_flip = None if kpf_dev is None else kpf_dev.cpu().numpy()
        sil = sil_dev.to(torch.bool).cpu().numpy()
        iuv = None if iuv_dev is None else iuv_dev.cpu().numpy()
        crop_wh = sil.shape[1]
        h, w = kp_logits.shape[1:3]
        # Stride from the batch actually given: the net is fully
        # convolutional, so keypoints come back in the given crop's pixels.
        stride = crop_wh // h
        comps, boxed, boxed_f = [], [], []
        for i in range(len(sil)):
            comp = largest_centred_component(sil[i].astype(np.float32))
            comps.append(comp)
            if comp is None:
                continue
            # Keypoint peaks only inside the picked instance's bbox, padded
            # by 2 cells.
            ys, xs = np.nonzero(comp)
            pad = 2
            y0 = max(ys.min() // stride - pad, 0)
            y1 = min(-(-ys.max() // stride) + pad, h)
            x0 = max(xs.min() // stride - pad, 0)
            x1 = min(-(-xs.max() // stride) + pad, w)
            for src, dst in ((kp_logits, boxed), (kp_logits_flip, boxed_f)):
                if src is not None:
                    m = np.full_like(src[i], -1e9)
                    m[y0:y1, x0:x1] = src[i, y0:y1, x0:x1]
                    dst.append(m)
        kps = (decode_keypoints(torch.from_numpy(np.stack(boxed)),
                                stride).numpy() if boxed else None)
        kpfs = (decode_keypoints(torch.from_numpy(np.stack(boxed_f)),
                                 stride).numpy() if boxed_f else None)
        results, n = [], 0
        for i, comp in enumerate(comps):
            if comp is None:
                results.append((None, None, None))
                continue
            kp = kps[n]
            if kpfs is not None:
                kp = self._merge_kp(kp, kpfs[n], crop_wh)
            n += 1
            results.append((kp, comp, None if iuv is None else iuv[i]))
        return results


class PlayerDetectorRunner:
    """Batched uint8 frames → scored person boxes, thresholded on the host.

    ``model`` is moved to ``device`` (None: the CUDA card) and put in eval
    mode; ``hw`` is the frames' (H, W), each divisible by 32."""

    def __init__(self, model: PlayerDetector, hw: Tuple[int, int],
                 score_thresh: float = cfg.DETECTION_SCORE_THRESH,
                 flip_tta: bool = False, device: DeviceLike = None):
        self.device = default_device(device)
        self.model = model.to(self.device).eval()
        self.hw = hw
        self.score_thresh = score_thresh
        self.flip_tta = flip_tta

    @torch.no_grad()
    def forward(self, frames_u8):
        """(B, H, W, 3) uint8 (numpy or tensor) → the decoded
        :class:`Detections` on the device, every one of the K slots."""
        images = torch.as_tensor(frames_u8).to(self.device)
        images = images.permute(0, 3, 1, 2).to(torch.float32) / 255.0
        out = (apply_flip_tta(self.model, images) if self.flip_tta
               else self.model(images))
        return decode_detections(out)

    def __call__(self, frames_u8) -> List[np.ndarray]:
        """(B, H, W, 3) uint8 frames → one (N_i, 4) [x1, y1, x2, y2] box
        array per frame, the boxes scoring at least ``score_thresh``."""
        dets = self.forward(frames_u8)
        boxes = dets.boxes.cpu().numpy()
        scores = dets.scores.cpu().numpy()
        return [b[s >= self.score_thresh] for b, s in zip(boxes, scores)]
