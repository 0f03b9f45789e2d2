"""Readers/writers for the reference's on-disk dataplane.

Counterpart of ``soccerplayershapepose_tpu/io/formats.py``, kept as a copy
so the port never imports the JAX package: the same functions write the
same bytes for the same arrays, so either package (and the C# annotation
GUI) reads a tree the other wrote. Host numpy only.

The reference's stages communicate exclusively through a folder tree and a
handful of JSON-in-``.xml`` / ``.npy`` / ``.npz`` files (SURVEY.md §2.11):

* ``boxes.xml`` — JSON list of [x1, y1, x2, y2] per broadcast scene
  (player_detection.py:206-207); ``index.xml`` — JSON list of player ids,
* proxy: ``<view>_j2d.xml`` — JSON (17, 3) keypoints; ``<view>_sil.npy`` —
  (512, 512) binary mask (player_recon.py:112-117),
* fit results: ``.npz`` {body_pose (1,23,3,3), global_orient (1,1,3,3),
  betas (1,10), translation (1,3)} (player_recon.py:1293-1294); multi-view
  shared ``data.npz`` {body_pose, betas} + per-view {translation,
  global_orient} (player_recon.py:1976-1979),
* ``metrics.xml`` — JSON [silh_iou, joint_err] (player_recon.py:1985-1986),
* baseline imports: HMR ``.npy`` (1, 85) = [cam3|pose72|shape10]; SPIN/PARE
  ``.npz`` {pred_rotmat, pred_betas, pred_camera} (hmr.py:198-231),
* folder layout ``<root>/<game>/<scene>/<player>/<view>.png`` with metric
  aggregation by tree walk (global_utils.py:297-318).

Outputs written here are byte-compatible so results are diffable
player-by-player against the reference, and the C# annotation GUI's refine
loop (boxes/index/j2d edits + score-gated re-optimization) keeps working.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# JSON-in-.xml primitives
# ---------------------------------------------------------------------------

def read_json_xml(path: str):
    with open(path, "r") as f:
        return json.load(f)


def write_json_xml(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def read_boxes(path: str) -> np.ndarray:
    """(N, 4) float boxes from boxes.xml."""
    return np.asarray(read_json_xml(path), dtype=np.float64).reshape(-1, 4)


def write_boxes(path: str, boxes: np.ndarray) -> None:
    write_json_xml(path, [[float(v) for v in b] for b in np.asarray(boxes)])


def read_index(path: str) -> List[int]:
    return [int(i) for i in read_json_xml(path)]


def write_index(path: str, ids) -> None:
    write_json_xml(path, [int(i) for i in ids])


def read_joints2d(path: str) -> np.ndarray:
    """(17, 3) keypoints from <view>_j2d.xml."""
    return np.asarray(read_json_xml(path), dtype=np.float64)


def write_joints2d(path: str, joints: np.ndarray) -> None:
    write_json_xml(path, [[float(v) for v in row] for row in np.asarray(joints)])


def read_metrics(path: str) -> Tuple[float, float]:
    """[silh_iou, joint_err] from metrics.xml."""
    vals = read_json_xml(path)
    return float(vals[0]), float(vals[1])


def write_metrics(path: str, silh_iou: float, joint_err: float) -> None:
    write_json_xml(path, [float(silh_iou), float(joint_err)])


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W[, 3]) uint8 image (vis outputs — *Vis folders)."""
    from soccerplayershapepose_torch.pipeline.densepose import encode_png
    with open(path, "wb") as f:
        f.write(encode_png(np.asarray(image, np.uint8)))


# ---------------------------------------------------------------------------
# Fit-result npz
# ---------------------------------------------------------------------------

def write_fit_npz(path: str, body_pose, global_orient, betas, translation):
    np.savez(path,
             body_pose=np.asarray(body_pose).reshape(1, 23, 3, 3),
             global_orient=np.asarray(global_orient).reshape(1, 1, 3, 3),
             betas=np.asarray(betas).reshape(1, 10),
             translation=np.asarray(translation).reshape(1, 3))


def read_fit_npz(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in ("body_pose", "global_orient", "betas",
                                  "translation")}


def write_multiview_npz(player_dir: str, body_pose, betas,
                        per_view: dict) -> None:
    """Shared data.npz + per-view npz files named like the reference."""
    os.makedirs(player_dir, exist_ok=True)
    np.savez(os.path.join(player_dir, "data.npz"),
             body_pose=np.asarray(body_pose).reshape(1, 23, 3, 3),
             betas=np.asarray(betas).reshape(1, 10))
    for view_name, d in per_view.items():
        np.savez(os.path.join(player_dir, view_name + ".npz"),
                 translation=np.asarray(d["translation"]).reshape(1, 3),
                 global_orient=np.asarray(d["global_orient"]).reshape(1, 1, 3, 3))


def read_multiview_npz(player_dir: str) -> dict:
    with np.load(os.path.join(player_dir, "data.npz")) as z:
        out = {"body_pose": z["body_pose"], "betas": z["betas"]}
    views = {}
    for name in sorted(os.listdir(player_dir)):
        if name.endswith(".npz") and name != "data.npz":
            with np.load(os.path.join(player_dir, name)) as z:
                views[name[:-4]] = {"translation": z["translation"],
                                    "global_orient": z["global_orient"]}
    out["views"] = views
    return out


# ---------------------------------------------------------------------------
# HMR / SPIN / PARE baseline imports (hmr.py:198-231)
# ---------------------------------------------------------------------------

def read_hmr_prediction(path: str) -> dict:
    """HMR .npy (1, 85): [cam s,tx,ty | 72 axis-angle pose | 10 betas]."""
    arr = np.load(path).reshape(-1)
    assert arr.size == 85, arr.shape
    return {"cam_wp": arr[:3].reshape(1, 3),
            "pose_axis_angle": arr[3:75].reshape(1, 24, 3),
            "betas": arr[75:].reshape(1, 10)}


def read_spin_prediction(path: str) -> dict:
    """SPIN/PARE .npz {pred_rotmat (1,24,3,3), pred_betas, pred_camera}."""
    with np.load(path) as z:
        return {"pose_rotmats": z["pred_rotmat"].reshape(1, 24, 3, 3),
                "betas": z["pred_betas"].reshape(1, 10),
                "cam_wp": z["pred_camera"].reshape(1, 3)}


# ---------------------------------------------------------------------------
# Folder-tree dataplane
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlayerTree:
    """One player node of the <root>/<game>/<scene>/<player> hierarchy."""
    game: str
    scene: str
    player: str
    path: str
    views: Tuple[str, ...]


def walk_player_tree(root: str,
                     view_suffix: str = ".png") -> Iterator[PlayerTree]:
    """Deterministically iterate the game/scene/player folder hierarchy."""
    for game in sorted(os.listdir(root)):
        game_dir = os.path.join(root, game)
        if not os.path.isdir(game_dir):
            continue
        for scene in sorted(os.listdir(game_dir)):
            scene_dir = os.path.join(game_dir, scene)
            if not os.path.isdir(scene_dir):
                continue
            for player in sorted(os.listdir(scene_dir)):
                player_dir = os.path.join(scene_dir, player)
                if not os.path.isdir(player_dir):
                    continue
                views = tuple(sorted(
                    v for v in os.listdir(player_dir)
                    if v.endswith(view_suffix)))
                yield PlayerTree(game, scene, player, player_dir, views)


def calc_metrics(root: str,
                 score_thresh: Optional[float] = None) -> dict:
    """Aggregate metrics.xml over the player tree (the reference's
    ``calc_metrics``, global_utils.py:297-318): mean silh_iou / joint_err,
    plus the count of players whose joint error exceeds the refine gate."""
    ious, errs = [], []
    flagged = 0
    for node in walk_player_tree(root, view_suffix="metrics.xml"):
        path = os.path.join(node.path, "metrics.xml")
        if not os.path.exists(path):
            continue
        iou, err = read_metrics(path)
        ious.append(iou)
        errs.append(err)
        if score_thresh is not None and err >= score_thresh:
            flagged += 1
    return {"mean_silh_iou": float(np.mean(ious)) if ious else float("nan"),
            "mean_joint_err": float(np.mean(errs)) if errs else float("nan"),
            "num_players": len(ious),
            "num_flagged_for_refine": flagged}
