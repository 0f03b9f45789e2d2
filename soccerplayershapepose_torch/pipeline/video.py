"""Video ingestion: match video → classified ``<game>/<scene>`` frame tree.

Counterpart of ``soccerplayershapepose_tpu/pipeline/video.py``, kept as a
copy so the port never imports the JAX package. Frames are sampled at
seeded random positions (``np.random.RandomState(seed)``, without
replacement when the video is long enough), decoded by seeking
``cv2.VideoCapture`` (``CAP_PROP_POS_FRAMES``), INTER_AREA-resized to the
broadcast size, and gated one at a time through a classifier (any
``frame_rgb_u8 → bool``, e.g. ``pipeline/classification.py:Classifier`` on
the card). Each accepted frame becomes its own
``<game>/<scene>/broad.png`` node, the scene named by its zero-padded frame
number, written with ``cv2.imwrite``, so ``crop_broad_player_stage``
consumes the tree directly.

Decode is host IO: OpenCV is imported inside the functions that need it,
and a missing ``cv2`` raises ImportError there.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

# The broadcast frame size every video is normalized to
# (global_var.py:8-9 default_size).
DEFAULT_SIZE_HW: Tuple[int, int] = (1080, 1920)


def _require_cv2():
    try:
        import cv2
    except ImportError as e:                     # pragma: no cover
        raise ImportError(
            "video ingestion needs OpenCV (cv2) for VideoCapture decode; "
            "install opencv-python or precompute the frame tree") from e
    return cv2


def video_frame_count(video_path: str) -> int:
    """Total frame count (CAP_PROP_FRAME_COUNT, classification.py:269)."""
    cv2 = _require_cv2()
    cap = cv2.VideoCapture(video_path)
    try:
        if not cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {video_path}")
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


def sample_video_frames(video_path: str,
                        n_samples: int,
                        seed: int = 0,
                        size_hw: Tuple[int, int] = DEFAULT_SIZE_HW,
                        replace: bool = False):
    """Yield ``(frame_number, frame_rgb_u8)`` for seeded random positions.

    Mirrors the reference's random-seek loop (classification.py:274-283):
    seek with CAP_PROP_POS_FRAMES, read one frame, INTER_AREA-resize to the
    broadcast size when the source resolution differs. Frames the decoder
    fails to produce are skipped (the reference swallows these in a bare
    except). Positions are drawn without replacement when the video has
    enough frames (the reference may sample duplicates; duplicates are
    wasted work downstream).
    """
    cv2 = _require_cv2()
    cap = cv2.VideoCapture(video_path)
    try:
        if not cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {video_path}")
        length = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if length <= 0:
            return
        rng = np.random.RandomState(seed)
        if replace or n_samples > length:
            positions = rng.randint(0, length, size=n_samples)
        else:
            positions = rng.choice(length, size=n_samples, replace=False)
        h, w = size_hw
        for pos in positions:
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(pos))
            ret, frame = cap.read()
            if not ret or frame is None:
                continue
            if frame.shape[0] != h or frame.shape[1] != w:
                frame = cv2.resize(frame, (w, h),
                                   interpolation=cv2.INTER_AREA)
            yield int(pos), frame[..., ::-1]     # BGR → RGB
    finally:
        cap.release()


def harvest_frames_stage(video_path: str,
                         out_root: str,
                         classifier: Optional[Callable[[np.ndarray], bool]]
                         = None,
                         game: Optional[str] = None,
                         n_samples: int = 500,
                         max_accepted: int = 200,
                         seed: int = 0,
                         size_hw: Tuple[int, int] = DEFAULT_SIZE_HW,
                         frame_name: str = "broad.png",
                         scene_offset: int = 0) -> Dict:
    """Video file → classified ``<out_root>/<game>/<scene>/broad.png`` tree.

    The ``predict_with_classifier_final`` role (classification.py:261-295):
    sample up to ``n_samples`` random frames, gate each through
    ``classifier`` (any ``frame_rgb_u8 → bool``; e.g.
    :class:`pipeline.classification.Classifier` — ``None`` accepts all),
    stop after ``max_accepted`` accepted frames. Each accepted frame lands
    in its own scene directory (named by its video frame number, zero-padded
    so lexicographic scene order is temporal order) ready for
    ``crop_broad_player_stage``.

    Returns ``{'game', 'sampled', 'accepted', 'written', 'scenes'}``.
    """
    game = game or os.path.splitext(os.path.basename(video_path))[0]
    cv2 = _require_cv2()
    sampled = accepted = 0
    scenes: List[str] = []
    for pos, frame in sample_video_frames(video_path, n_samples, seed=seed,
                                          size_hw=size_hw):
        sampled += 1
        if classifier is not None and not classifier(frame):
            continue
        scene = f"{scene_offset + pos:08d}"
        scene_dir = os.path.join(out_root, game, scene)
        os.makedirs(scene_dir, exist_ok=True)
        ok = cv2.imwrite(os.path.join(scene_dir, frame_name),
                         frame[..., ::-1])       # RGB → BGR for imwrite
        if not ok:                               # pragma: no cover
            continue
        scenes.append(scene)
        accepted += 1
        if accepted >= max_accepted:
            break
    return {"game": game, "sampled": sampled, "accepted": accepted,
            "written": accepted, "scenes": sorted(scenes)}


def sample_for_labeling(video_paths: Sequence[str],
                        out_dir: str,
                        per_video: int = 2,
                        seed: int = 0,
                        size_hw: Tuple[int, int] = DEFAULT_SIZE_HW) -> Dict:
    """Unlabeled classifier-training frame pool (``prepare_data`` role,
    classification.py:18-76, ``classification_frame_per_video`` = 2).

    The reference labels frames interactively (cv2.imshow + keypress, a GUI
    loop out of scope like the WPF annotation tool); this writes the sampled
    frames to ``out_dir`` as ``<video-stem>_<frame>.png`` for offline
    labeling into the ``1/`` / ``2/`` class folders ``train_classifier``
    consumes.
    """
    cv2 = _require_cv2()
    os.makedirs(out_dir, exist_ok=True)
    written: List[str] = []
    for k, path in enumerate(video_paths):
        stem = os.path.splitext(os.path.basename(path))[0]
        for pos, frame in sample_video_frames(path, per_video,
                                              seed=seed + k,
                                              size_hw=size_hw):
            name = f"{stem}_{pos:08d}.png"
            if cv2.imwrite(os.path.join(out_dir, name), frame[..., ::-1]):
                written.append(name)
    return {"written": len(written), "files": sorted(written)}
