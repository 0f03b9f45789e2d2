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

:func:`create_proxy_stage` runs the extractor over a
``<game>/<scene>/<player>/<view>.png`` crop tree and writes each view's
proxy (``<view>_j2d.xml``, ``<view>_sil.npy``, optionally
``<view>_iuv.npy`` and a ``<view>_silhouette.png`` overlay), deleting a
player whose extraction failed in any view.

The detection stages run a :class:`PlayerDetectorRunner` (or anything with
its ``hw`` and ``__call__``) over frames read from disk, resized to the
runner's size in batches and their boxes scaled back, and crop on the host
with ``pipeline/detection.py``: :func:`crop_player_stage` writes one 512²
crop of the centre-most player per view of a
``<game>/<scene>/<player>/<view>.png`` tree; :func:`crop_broad_player_stage`
writes each ``<game>/<scene>`` frame's ``boxes.xml`` (``<stem>_boxes.xml``
for the extra frames of a scene that holds several) and a box overlay;
:func:`crop_broad_player_images_stage` crops every box of a scene's
``boxes.xml`` into ``<index>/player.png`` (indexes from ``index.xml``, else
2, 3, …); :func:`detect_players_stage` fuses the two broad stages. All
files are written with ``io.write_png``, byte-equal to the JAX package's.
"""

from __future__ import annotations

import os
import shutil
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.io import formats as io
from soccerplayershapepose_torch.models.detector import (
    PlayerDetector, apply_flip_tta, decode_detections)
from soccerplayershapepose_torch.models.perception import (
    ProxyNet, decode_iuv, decode_keypoints, decode_silhouette)
from soccerplayershapepose_torch.pipeline.detection import (
    crop_broadcast_players, crop_player_view, select_centre_player)
from soccerplayershapepose_torch.pipeline.preprocess import square_crop_padded
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, default_device)


def read_image(path: str, wh: Optional[int] = None) -> np.ndarray:
    """PNG/JPEG → (H, W, 3) uint8 RGB, bilinear-resized to wh² when given
    (the reference's cv2 INTER_LINEAR resize, through PIL)."""
    from PIL import Image
    img = Image.open(path).convert("RGB")
    if wh is not None and img.size != (wh, wh):
        img = img.resize((wh, wh), Image.BILINEAR)
    return np.asarray(img, np.uint8)


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


def _proxy_vis(image: np.ndarray, sil: np.ndarray,
               keypoints: np.ndarray) -> np.ndarray:
    """Overlay vis: 0.7·image + 0.3·mask, keypoints as green squares."""
    vis = (image.astype(np.float32) * 0.7
           + sil[..., None] * 128.0 * 0.3).astype(np.uint8)
    h, w = sil.shape
    for x, y, _ in keypoints:
        x0, y0 = int(x), int(y)
        vis[max(y0 - 3, 0):min(y0 + 4, h),
            max(x0 - 3, 0):min(x0 + 4, w)] = (0, 255, 0)
    return vis


def create_proxy_stage(extractor: ProxyExtractor, image_root: str,
                       proxy_root: str, vis_root: Optional[str] = None,
                       ignore_first: bool = True, batch_size: int = 8,
                       write_iuv: bool = False,
                       skip_existing: bool = True) -> dict:
    """Folder-tree proxy extraction from raw crops.

    Every view of every player under ``image_root`` (player '1', the
    camera-man crop, skipped with ``ignore_first``; views whose proxy
    exists skipped with ``skip_existing``) is read at the extractor's
    size, in batches of ``batch_size`` (the last one padded by repeating
    its last crop, so the forward always sees ``batch_size`` crops). A
    player whose extraction fails in any view is deleted from
    ``proxy_root`` at once and written no further.

    Returns {'written': n_views, 'failed_players': [game/scene/player]}.
    """
    jobs: List[Tuple[io.PlayerTree, str]] = []
    for node in io.walk_player_tree(image_root):
        if ignore_first and node.player == "1":
            continue
        for view in node.views:
            stem = os.path.join(proxy_root, node.game, node.scene,
                                node.player, os.path.splitext(view)[0])
            if skip_existing and os.path.exists(stem + "_sil.npy") \
                    and os.path.exists(stem + "_j2d.xml"):
                continue
            jobs.append((node, view))

    written = 0
    failed: List[str] = []
    failed_set = set()   # player keys: keeps the delete atomic per player
    for start in range(0, len(jobs), batch_size):
        chunk = jobs[start:start + batch_size]
        images = np.stack([
            read_image(os.path.join(n.path, v), extractor.wh)
            for n, v in chunk])
        pad = batch_size - len(chunk)
        if pad:
            images = np.concatenate([images,
                                     np.repeat(images[-1:], pad, axis=0)])
        results = extractor(images)
        for (node, view), (kp, sil, iuv), img in zip(chunk, results, images):
            key = os.path.join(node.game, node.scene, node.player)
            if key in failed_set:
                # A sibling view already failed and the player was deleted:
                # never resurrect it with a partial proxy set.
                continue
            player_dst = os.path.join(proxy_root, node.game, node.scene,
                                      node.player)
            if kp is None:
                if os.path.isdir(player_dst):
                    shutil.rmtree(player_dst)
                failed.append(key)
                failed_set.add(key)
                continue
            os.makedirs(player_dst, exist_ok=True)
            stem = os.path.join(player_dst, os.path.splitext(view)[0])
            io.write_joints2d(stem + "_j2d.xml", kp)
            np.save(stem + "_sil.npy", sil.astype(np.uint8))
            if write_iuv and iuv is not None:
                np.save(stem + "_iuv.npy", iuv.astype(np.float32))
            if vis_root is not None:
                vis_dir = os.path.join(vis_root, node.game, node.scene,
                                       node.player)
                os.makedirs(vis_dir, exist_ok=True)
                io.write_png(os.path.join(
                    vis_dir, os.path.splitext(view)[0] + "_silhouette.png"),
                    _proxy_vis(img, sil, kp))
            written += 1
    return {"written": written, "failed_players": failed}


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


def _scene_frames(frame_root: str) -> List[Tuple[str, str, List[str]]]:
    """[(game, scene, [frame filenames])] — every image in every scene dir."""
    scenes = []
    for game in sorted(os.listdir(frame_root)):
        gdir = os.path.join(frame_root, game)
        if not os.path.isdir(gdir):
            continue
        for scene in sorted(os.listdir(gdir)):
            sdir = os.path.join(gdir, scene)
            if not os.path.isdir(sdir):
                continue
            frames = sorted(f for f in os.listdir(sdir)
                            if f.endswith((".png", ".jpg")))
            if frames:
                scenes.append((game, scene, frames))
    return scenes


def _run_detector_batched(runner: PlayerDetectorRunner, jobs: Sequence[str],
                          batch_size: int):
    """Detect over a list of image paths; yields (path, orig, boxes) with
    boxes rescaled back to original-image pixel space."""
    h, w = runner.hw
    for start in range(0, len(jobs), batch_size):
        chunk = jobs[start:start + batch_size]
        raw = [read_image(path) for path in chunk]
        frames = np.stack([_resize_frame(r, (h, w)) for r in raw])
        per_frame = runner(frames)
        for path, boxes, orig in zip(chunk, per_frame, raw):
            sy = orig.shape[0] / h
            sx = orig.shape[1] / w
            yield path, orig, boxes * np.array([sx, sy, sx, sy])


def _draw_boxes(image: np.ndarray, boxes: np.ndarray,
                color=(255, 0, 0), thickness: int = 2) -> np.ndarray:
    """Box-rectangle overlay vis (cv2.rectangle role,
    player_detection.py:183-188)."""
    vis = image.copy()
    h, w = vis.shape[:2]
    for x1, y1, x2, y2 in np.asarray(boxes, np.int64):
        x1, x2 = np.clip([x1, x2], 0, w - 1)
        y1, y2 = np.clip([y1, y2], 0, h - 1)
        for d in range(thickness):
            vis[max(y1 - d, 0), x1:x2 + 1] = color
            vis[min(y2 + d, h - 1), x1:x2 + 1] = color
            vis[y1:y2 + 1, max(x1 - d, 0)] = color
            vis[y1:y2 + 1, min(x2 + d, w - 1)] = color
    return vis


def crop_player_stage(runner: PlayerDetectorRunner, image_root: str,
                      out_root: str, batch_size: int = 8,
                      skip_player_one: bool = True,
                      skip_if_present_root: Optional[str] = None,
                      border: int = cfg.PLAYER_CROP_BORDER,
                      out_size: int = cfg.PLAYER_CROP_SIZE[0],
                      save_mid: bool = False) -> dict:
    """Per-view crop driver: the reference ``crop_player``
    (player_detection.py:83-147).

    Walks ``<root>/<game>/<scene>/<player>/<view>.png``, detects the
    centre-most player in EVERY view, and writes the bordered green-padded
    square crop (resized to ``out_size``²) back as
    ``<out>/<game>/<scene>/<player>/<view>`` — the input layout every
    downstream stage consumes. ``skip_player_one`` mirrors ``check_index``
    (player ``'1'`` is the reference/broad slot, :109-111);
    ``skip_if_present_root`` mirrors ``check_board`` (skip players already in
    the broadcast tree, :112-114). ``save_mid`` writes a ``*_rect.png`` box
    overlay next to each crop (:132-135).

    Returns {'written', 'skipped', 'missed': [view paths with no detection]}.
    """
    jobs: List[Tuple[io.PlayerTree, str]] = []
    skipped = 0
    for node in io.walk_player_tree(image_root):
        if skip_player_one and node.player == "1":
            skipped += len(node.views)
            continue
        if skip_if_present_root is not None and os.path.exists(
                os.path.join(skip_if_present_root, node.game, node.scene,
                             node.player)):
            skipped += len(node.views)
            continue
        for view in node.views:
            jobs.append((node, view))

    written = 0
    missed: List[str] = []
    paths = [os.path.join(n.path, v) for n, v in jobs]
    for (node, view), (path, orig, boxes) in zip(
            jobs, _run_detector_batched(runner, paths, batch_size)):
        crop = crop_player_view(orig, boxes, border=border)
        if crop is None:
            missed.append(os.path.join(node.game, node.scene, node.player,
                                       view))
            continue
        if crop.shape[0] != out_size:
            crop = _resize_frame(crop, (out_size, out_size))
        player_dst = os.path.join(out_root, node.game, node.scene,
                                  node.player)
        os.makedirs(player_dst, exist_ok=True)
        io.write_png(os.path.join(player_dst, view), crop)
        if save_mid:
            centre = select_centre_player(boxes, orig.shape[:2])
            io.write_png(
                os.path.join(player_dst,
                             os.path.splitext(view)[0] + "_rect.png"),
                _draw_boxes(orig, centre[None]))
        written += 1
    return {"written": written, "skipped": skipped, "missed": missed}


def crop_broad_player_stage(runner: PlayerDetectorRunner, frame_root: str,
                            box_root: str, vis_root: Optional[str] = None,
                            batch_size: int = 4) -> dict:
    """Broadcast detection driver: the reference ``crop_broad_player``
    (player_detection.py:152-208).

    For EVERY frame image in each ``<game>/<scene>`` dir: detect all
    players, write the box list as JSON ``boxes.xml``
    (player_detection.py:206-207) and a rectangle-overlay vis. The canonical
    scene holds exactly one ``broad.png`` whose boxes become the scene-level
    ``boxes.xml``; additional frames get ``<stem>_boxes.xml`` so nothing is
    silently dropped.

    Returns {'scenes', 'frames', 'boxes'}.
    """
    scenes = _scene_frames(frame_root)
    jobs = [(g, s, f, len(frames) > 1)
            for g, s, frames in scenes for f in frames]

    n_boxes = 0
    paths = [os.path.join(frame_root, g, s, f) for g, s, f, _ in jobs]
    for (game, scene, fname, multi), (path, orig, boxes) in zip(
            jobs, _run_detector_batched(runner, paths, batch_size)):
        scene_out = os.path.join(box_root, game, scene)
        os.makedirs(scene_out, exist_ok=True)
        stem = os.path.splitext(fname)[0]
        box_name = (stem + "_boxes.xml") if multi and stem != "broad" \
            else "boxes.xml"
        io.write_boxes(os.path.join(scene_out, box_name), boxes)
        n_boxes += len(boxes)
        if vis_root is not None:
            vis_dir = os.path.join(vis_root, game, scene)
            os.makedirs(vis_dir, exist_ok=True)
            io.write_png(os.path.join(vis_dir, fname),
                         _draw_boxes(orig, boxes))
    return {"scenes": len(scenes), "frames": len(jobs), "boxes": n_boxes}


def crop_broad_player_images_stage(box_root: str, frame_root: str,
                                   image_root: str,
                                   frame_name: str = "broad.png",
                                   out_size: int = cfg.PLAYER_CROP_SIZE[0]
                                   ) -> dict:
    """Indexed broadcast crop driver: the reference
    ``crop_broad_player_images`` (player_detection.py:213-250).

    Reads each scene's ``boxes.xml`` + optional ``index.xml`` (player ids
    assigned in the annotation GUI; defaults to ``2..len(boxes)+1`` — :238),
    crops every box from the broadcast frame with border 0, and writes
    ``<image_root>/<game>/<scene>/<index>/player.png``.

    Returns {'scenes', 'crops'}.
    """
    n_scenes = n_crops = 0
    for game, scene, frames in _scene_frames(frame_root):
        sdir = os.path.join(box_root, game, scene)
        boxes_path = os.path.join(sdir, "boxes.xml")
        fname = frame_name if frame_name in frames else frames[0]
        if not os.path.exists(boxes_path):
            continue
        boxes = io.read_boxes(boxes_path)
        index_path = os.path.join(sdir, "index.xml")
        indexes = io.read_index(index_path) if os.path.exists(index_path) \
            else list(range(2, len(boxes) + 2))
        image = read_image(os.path.join(frame_root, game, scene, fname))
        n_scenes += 1
        for box, index in zip(boxes, indexes):
            crop = square_crop_padded(image, box, border=0,
                                      out_size=out_size)
            pdir = os.path.join(image_root, game, scene, str(index))
            os.makedirs(pdir, exist_ok=True)
            io.write_png(os.path.join(pdir, "player.png"), crop)
            n_crops += 1
    return {"scenes": n_scenes, "crops": n_crops}


def detect_players_stage(runner: PlayerDetectorRunner, frame_root: str,
                         out_root: str, batch_size: int = 4,
                         broadcast: bool = True) -> dict:
    """Fused broadcast driver: boxes + indexed crops in one pass.

    Every frame image in each ``<game>/<scene>`` is processed. With
    ``broadcast=True``: per-frame ``boxes.xml`` (crop_broad_player role) plus
    one green-padded 512² crop per player
    (``<out>/<game>/<scene>[/<frame stem>]/<idx>/player.png`` — the frame-stem
    level appears only when a scene holds more than one frame, so the
    canonical single-``broad.png`` layout matches crop_broad_player_images
    exactly). With ``broadcast=False``: one centre-player crop per frame
    (crop_player single-frame role).
    """
    scenes = _scene_frames(frame_root)
    jobs = [(g, s, f, len(frames) > 1)
            for g, s, frames in scenes for f in frames]
    n_boxes = 0
    paths = [os.path.join(frame_root, g, s, f) for g, s, f, _ in jobs]
    for (game, scene, fname, multi), (path, orig, boxes) in zip(
            jobs, _run_detector_batched(runner, paths, batch_size)):
        scene_out = os.path.join(out_root, game, scene)
        os.makedirs(scene_out, exist_ok=True)
        stem = os.path.splitext(fname)[0]
        box_name = (stem + "_boxes.xml") if multi and stem != "broad" \
            else "boxes.xml"
        io.write_boxes(os.path.join(scene_out, box_name), boxes)
        n_boxes += len(boxes)
        if broadcast:
            base = os.path.join(scene_out, stem) if multi else scene_out
            for i, crop in enumerate(crop_broadcast_players(orig, boxes)):
                pdir = os.path.join(base, str(i + 1))
                os.makedirs(pdir, exist_ok=True)
                io.write_png(os.path.join(pdir, "player.png"), crop)
        else:
            crop = crop_player_view(orig, boxes)
            if crop is not None:
                name = (stem + "_player.png") if multi else "player.png"
                io.write_png(os.path.join(scene_out, name), crop)
    return {"scenes": len(scenes), "boxes": n_boxes}


def _resize_frame(image: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.fromarray(image).resize(
        (hw[1], hw[0]), Image.BILINEAR), np.uint8)
