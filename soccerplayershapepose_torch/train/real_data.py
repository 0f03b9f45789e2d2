"""Real-crop training source: ProxyNet batches from a crop and proxy tree.

Counterpart of ``soccerplayershapepose_tpu/train/real_data.py``. A
``<game>/<scene>/<player>/<view>`` crop tree and its sibling proxy tree
(``*_j2d.xml``, ``*_sil.npy`` and optionally ``*_iuv.npy``, the files the
create-proxy stage writes, ``io/formats.py``) become ProxyNet training
batches with the contract of the synthetic crops (``train/synth.py``), so
the trainer can mix the two sources.

A keypoint is visible where its stored score is above ``score_thresh`` and
it lies in the frame. A crop without an IUV file gets ``iuv_valid = 0``,
and the part and UV losses skip it. The batches are numpy, drawn from
``np.random.RandomState`` exactly as the JAX package draws them, so both
packages read the same crops in the same order for a seed.
"""

from __future__ import annotations

import os
from typing import Callable, Iterator, List, Optional

import numpy as np

from soccerplayershapepose_torch.io import formats as io
from soccerplayershapepose_torch.models.perception import STRIDE
from soccerplayershapepose_torch.pipeline.extract import read_image


def collect_proxy_examples(image_root: str, proxy_root: str,
                           ignore_first: bool = True) -> List[dict]:
    """``{image, j2d, sil[, iuv]}`` file records over the paired trees,
    views that lack a keypoint or a silhouette file left out (and player
    "1", the reference's ignored slot, with ``ignore_first``)."""
    out = []
    for node in io.walk_player_tree(image_root):
        if ignore_first and node.player == "1":
            continue
        for view in node.views:
            stem = os.path.join(proxy_root, node.game, node.scene,
                                node.player, os.path.splitext(view)[0])
            if not (os.path.exists(stem + "_j2d.xml")
                    and os.path.exists(stem + "_sil.npy")):
                continue
            rec = {"image": os.path.join(node.path, view),
                   "j2d": stem + "_j2d.xml", "sil": stem + "_sil.npy"}
            if os.path.exists(stem + "_iuv.npy"):
                rec["iuv"] = stem + "_iuv.npy"
            out.append(rec)
    return out


def _load_example(rec: dict, wh: int, score_thresh: float):
    """One record → (image (wh, wh, 3) in [0, 1], silhouette (wh, wh),
    joints (17, 2), visibility (17,), part (wh/4, wh/4), uv (wh/4, wh/4,
    2), iuv_valid). The mask is resized by nearest index and the keypoints
    rescale with it; the IUV is sampled at the stride-4 cells' centres."""
    image = read_image(rec["image"], wh).astype(np.float32) / 255.0
    j2d = io.read_joints2d(rec["j2d"]).astype(np.float32)     # (17, 3)
    sil = np.load(rec["sil"]).astype(np.float32)
    native = sil.shape[0]
    if native != wh:
        idx = (np.arange(wh) * native / wh).astype(np.int64)
        sil = sil[idx][:, idx]
        j2d = j2d * np.array([wh / native, wh / native, 1.0], np.float32)
    vis = ((j2d[:, 2] > score_thresh)
           & (j2d[:, 0] >= 0) & (j2d[:, 0] < wh)
           & (j2d[:, 1] >= 0) & (j2d[:, 1] < wh)).astype(np.float32)

    small = wh // STRIDE
    if "iuv" in rec:
        iuv = np.load(rec["iuv"]).astype(np.float32)          # (H, W, 3)
        s = iuv.shape[0] // small
        part = iuv[s // 2::s, s // 2::s, 0].astype(np.int32)[:small, :small]
        uv = iuv[s // 2::s, s // 2::s, 1:][:small, :small] / 255.0
        iuv_valid = 1.0
    else:
        part = np.zeros((small, small), np.int32)
        uv = np.zeros((small, small, 2), np.float32)
        iuv_valid = 0.0
    return image, sil, j2d[:, :2], vis, part, uv, iuv_valid


def proxy_tree_batches(image_root: str, proxy_root: str, batch: int,
                       wh: int = 256, score_thresh: float = 0.3,
                       seed: int = 0, loop: bool = True,
                       ignore_first: bool = True) -> Iterator[dict]:
    """Yield ProxyNet training batches (numpy: ``image``, ``silhouette``,
    ``joints2d``, ``kp_visible``, ``part``, ``uv`` and an ``iuv_valid``
    (B,) mask) of ``batch`` crops picked with replacement from the tree
    by ``RandomState(seed)``; one batch unless ``loop``; none from an empty
    tree."""
    recs = collect_proxy_examples(image_root, proxy_root,
                                  ignore_first=ignore_first)
    if not recs:
        return
    rng = np.random.RandomState(seed)
    while True:
        picks = rng.randint(0, len(recs), size=batch)
        cols = [[] for _ in range(7)]
        for i in picks:
            for c, v in zip(cols, _load_example(recs[i], wh, score_thresh)):
                c.append(v)
        yield {"image": np.stack(cols[0]),
               "silhouette": np.stack(cols[1]),
               "joints2d": np.stack(cols[2]),
               "kp_visible": np.stack(cols[3]),
               "part": np.stack(cols[4]),
               "uv": np.stack(cols[5]),
               "iuv_valid": np.asarray(cols[6], np.float32)}
        if not loop:
            return


def mixed_batches(synth_fn: Callable[[int], dict],
                  real_iter: Optional[Iterator[dict]], p_real: float = 0.5,
                  seed: int = 0, start: int = 0) -> Iterator[dict]:
    """Mix synthetic batches (``synth_fn(step)``) with a real-proxy
    iterator: a real batch with probability ``p_real`` while the iterator
    lasts (``RandomState(seed + 1)`` decides), a synthetic one otherwise
    and once it is exhausted.

    ``start`` resumes the mix at that step: the decisions of the steps
    before it are replayed and the real iterator advanced past the real
    batches they took, without calling ``synth_fn``, so the batches from
    ``start`` on are those an unbroken run gives there."""
    rng = np.random.RandomState(seed + 1)
    step = 0
    while True:
        use_real = real_iter is not None and rng.rand() < p_real
        if use_real:
            try:
                batch = next(real_iter)
            except StopIteration:
                real_iter = None
            else:
                if step >= start:
                    yield batch
                step += 1
                continue
        if step >= start:
            yield synth_fn(step)
        step += 1
