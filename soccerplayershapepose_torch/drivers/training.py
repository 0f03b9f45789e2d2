"""Folder-tree distillation training and its evaluations.

Counterpart of ``soccerplayershapepose_tpu/drivers/training.py``: per scene,
gather every player's broadcast proxy and broadcast-view pseudo-GT into one
batch padded to ``max_players`` (the last real player repeated, a mask
keeping the padding out of the losses and the sums), train the regressor
with the multi-task loss (``train/distill.py``), split train/val by game
(``Data/train_set.xml``, else the first 80% of the games; with no held-out
game the last train scene validates), track the PVE/MPJPE family
(``metrics/tracker.py``) and checkpoint the current and best weights every
epoch with the all-val-metrics-improve rule (``train/checkpoint.py``).

The order of the scenes in an epoch is the JAX package's: one
``np.random.RandomState(seed)`` permutation per epoch. Every entry point
runs on ``device`` (None: the CUDA card). :func:`evaluate_model_relate`
refines the regressor's rotmats with the relation module over each
scene's boxes, optionally re-fitting each player's [orient, camera]
(``fit/broad_view.py``, joints only).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.drivers.stages import load_proxy_batch
from soccerplayershapepose_torch.io import formats as io
from soccerplayershapepose_torch.metrics import measures
from soccerplayershapepose_torch.metrics.tracker import MetricsTracker
from soccerplayershapepose_torch.models.relation import PoseRelationModule
from soccerplayershapepose_torch.pipeline.predict import on_device
from soccerplayershapepose_torch.pipeline.proxy import (
    create_proxy_representation)
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.train.checkpoint import (
    CheckpointManager, params_snapshot)
from soccerplayershapepose_torch.train.distill import (
    TrainState, make_eval_step, make_train_state, make_train_step,
    new_regressor)
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, default_device)

TRACKED_METRICS = ("pves", "pves_sc", "pves_pa", "pve-ts", "pve-ts_sc",
                   "mpjpes", "mpjpes_sc", "mpjpes_pa",
                   "pose_mses", "shape_mses", "joints2D_l2es")
SAVE_VAL_METRICS = ("pves_pa", "mpjpes_pa")
TRACKED_LOSSES = ("verts", "joints2D", "joints3D", "pose_params",
                  "shape_params")
# Elements per sample of each metric family in the evaluations' means.
_PER_SAMPLE = {"pve": 6890, "mpjpe": 14, "pose_mse": 216, "shape_mse": 10}


def read_train_split(path: str) -> List[str]:
    """Game names in the train split (``Data/train_set.xml``, a JSON
    list)."""
    return [str(g) for g in io.read_json_xml(path)]


def gather_scene_batches(image_root: str, proxy_root: str, target_root: str,
                         max_players: int = cfg.MAX_PLAYERS_PER_FRAME
                         ) -> List[dict]:
    """One padded batch per scene, in sorted (game, scene) order: the
    first view's proxy of each player (at most ``max_players``) and its
    pseudo-GT ``data.npz``, as numpy."""
    scenes: Dict[Tuple[str, str], List[io.PlayerTree]] = {}
    for node in io.walk_player_tree(image_root):
        tgt = os.path.join(target_root, node.game, node.scene, node.player,
                           "data.npz")
        prx = os.path.join(proxy_root, node.game, node.scene, node.player)
        if os.path.exists(tgt) and os.path.isdir(prx) and node.views:
            scenes.setdefault((node.game, node.scene), []).append(node)

    batches = []
    for (game, scene), nodes in sorted(scenes.items()):
        nodes = nodes[:max_players]
        sils, joints, poses, betas = [], [], [], []
        for node in nodes:
            prx = os.path.join(proxy_root, node.game, node.scene, node.player)
            s, j = load_proxy_batch(prx, node.views[:1])
            sils.append(s[0])
            joints.append(j[0])
            d = io.read_fit_npz(os.path.join(target_root, node.game,
                                             node.scene, node.player,
                                             "data.npz"))
            poses.append(np.concatenate([d["global_orient"][0],
                                         d["body_pose"][0]], axis=0))
            betas.append(d["betas"][0])
        n = len(nodes)
        pad = max_players - n

        def padded(arr_list):
            arr = np.stack(arr_list).astype(np.float32)
            if pad:
                arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
            return arr

        batches.append({
            "game": game, "scene": scene, "num_real": n,
            "silhouette": padded(sils), "joints2d": padded(joints),
            "target_pose": padded(poses), "target_betas": padded(betas),
            "mask": (np.arange(max_players) < n).astype(np.float32)})
    return batches


def _device_batch(batch: dict, dev: torch.device) -> dict:
    """A gathered batch on ``dev`` with its 18-channel proxy."""
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    j2d = t(batch["joints2d"])
    return {"proxy": create_proxy_representation(t(batch["silhouette"]), j2d),
            "joints2d": j2d[..., :2].contiguous(),
            "target_pose": t(batch["target_pose"]),
            "target_betas": t(batch["target_betas"]),
            "mask": t(batch["mask"])}


@torch.no_grad()
def _metric_sums(aux: dict, mask) -> Dict[str, float]:
    """Per-batch metric SUMS over the real players (10 scalars to the
    host); MPJPE over the 14 LSP joints of the H36M regressor."""
    pred, target = aux["pred"], aux["target"]
    j14 = [cfg.ALL_JOINTS_TO_H36M_MAP[j] for j in cfg.H36M_TO_J14]
    pj, tj = pred["joints3D"][:, j14], target["joints3D"][:, j14]
    m = torch.as_tensor(np.asarray(mask, np.float32), device=pj.device)
    vals = {
        "pves": measures.pve(pred["verts"], target["verts"]),
        "pves_sc": measures.pve_sc(pred["verts"], target["verts"]),
        "pves_pa": measures.pve_pa(pred["verts"], target["verts"]),
        "pve-ts": measures.pve(pred["reposed_verts"],
                               target["reposed_verts"]),
        "pve-ts_sc": measures.pve_sc(pred["reposed_verts"],
                                     target["reposed_verts"]),
        "mpjpes": measures.mpjpe(pj, tj),
        "mpjpes_sc": measures.mpjpe_sc(pj, tj),
        "mpjpes_pa": measures.mpjpe_pa(pj, tj),
        "pose_mses": measures.pose_mse(pred["pose_rotmats"],
                                       target["pose_rotmats"]),
        "shape_mses": measures.shape_mse(pred["betas"], target["betas"]),
    }
    sums = torch.stack([torch.sum(v * m) for v in vals.values()]).cpu()
    return {k: float(s) for k, s in zip(vals, sums)}


def _task_losses(step_metrics: dict) -> Dict[str, float]:
    return {k.split("/", 1)[1]: float(v) for k, v in step_metrics.items()
            if k.startswith("loss/")}


def train_regressor(assets: SMPLAssets,
                    image_root: str, proxy_root: str, target_root: str,
                    checkpoint_dir: str,
                    train_games: Optional[Sequence[str]] = None,
                    epochs: int = cfg.REGRESSOR_TRAIN_EPOCHS,
                    learning_rate: float = cfg.REGRESSOR_TRAIN_LR,
                    in_channels: int = 18,
                    max_players: int = cfg.MAX_PLAYERS_PER_FRAME,
                    log_path: Optional[str] = None,
                    seed: int = 0,
                    resume: bool = False,
                    init_weights: Optional[str] = None,
                    device: DeviceLike = None) -> dict:
    """Scene-batched distillation training (see the module docstring).

    The regressor starts from flax's initialisers drawn from ``seed``
    (``train/distill.py:new_regressor``), or with ``init_weights`` from a
    regressor npz in the flat flax layout (parameters and BN statistics).
    ``resume`` restores ``<checkpoint_dir>/latest`` (weights, BN
    statistics, log-variances, Adam's moments and count, the best epoch
    and its metrics) and reloads the tracker's history from ``log_path``;
    the epoch counter continues. Returns {state, best_params (flat flax
    names), best_epoch, best_val, history}.
    """
    from soccerplayershapepose_torch.convert import (
        load_regressor_weights)
    dev = default_device(device)
    assets = on_device(assets, dev)
    if init_weights:
        regressor = load_regressor_weights(init_weights, dev)
    else:
        regressor = new_regressor(in_channels, seed, dev)
    state = make_train_state(regressor, learning_rate=learning_rate)
    train_step = make_train_step()
    eval_step = make_eval_step()

    batches = gather_scene_batches(image_root, proxy_root, target_root,
                                   max_players)
    if train_games is None:
        games = sorted({b["game"] for b in batches})
        train_games = games[:max(1, int(len(games) * 0.8))]
    train_batches = [b for b in batches if b["game"] in set(train_games)]
    val_batches = [b for b in batches if b["game"] not in set(train_games)] \
        or train_batches[-1:]

    tracker = MetricsTracker(losses_to_track=list(TRACKED_LOSSES),
                             metrics_to_track=list(TRACKED_METRICS),
                             log_path=log_path)
    ckpt = CheckpointManager(checkpoint_dir, list(SAVE_VAL_METRICS))

    best_epoch = 0
    best_params = params_snapshot(state)
    best_val = {m: np.inf for m in SAVE_VAL_METRICS}
    start_epoch = 1
    if resume and os.path.exists(os.path.join(checkpoint_dir, "latest")):
        state, best_params, meta = ckpt.restore(state)
        best_epoch = meta["best_epoch"]
        best_val = meta["best_epoch_val_metrics"]
        start_epoch = meta["epoch"] + 1
        if log_path and os.path.exists(log_path):
            tracker.load(log_path, meta["epoch"])

    rng = np.random.RandomState(seed)
    for epoch in range(start_epoch, epochs + 1):
        order = rng.permutation(len(train_batches))
        for i in order:
            db = _device_batch(train_batches[i], dev)
            state, step_metrics, aux = train_step(state, assets, db)
            sums = _metric_sums(aux, train_batches[i]["mask"])
            sums["joints2D_l2es"] = 0.0
            tracker.update_per_batch("train", float(step_metrics["loss"]),
                                     _task_losses(step_metrics), sums,
                                     train_batches[i]["num_real"])
        for b in val_batches:
            step_metrics, aux = eval_step(state, assets,
                                          _device_batch(b, dev))
            sums = _metric_sums(aux, b["mask"])
            sums["joints2D_l2es"] = 0.0
            tracker.update_per_batch("val", float(step_metrics["loss"]),
                                     _task_losses(step_metrics), sums,
                                     b["num_real"])
        tracker.update_per_epoch()

        if tracker.determine_save_model_weights_this_epoch(
                list(SAVE_VAL_METRICS), best_val):
            best_epoch = epoch
            best_params = params_snapshot(state)
            for m in SAVE_VAL_METRICS:
                best_val[m] = tracker.history[f"val_{m}"][-1]
        ckpt.save(epoch, state, best_params, best_epoch,
                  {k: float(v) for k, v in best_val.items()})

    return {"state": state, "best_params": best_params,
            "best_epoch": best_epoch, "best_val": best_val,
            "history": tracker.history}


def _divisor(metric: str) -> int:
    """Elements per sample of ``metric`` in :func:`evaluate_model`."""
    for key, n in _PER_SAMPLE.items():
        if key in metric.replace("-", "_") or key in metric:
            return n
    return 1


def _divisor_relate(metric: str) -> int:
    """Elements per sample of ``metric`` in :func:`evaluate_model_relate`
    (the JAX package's second helper, kept as it is)."""
    for key, n in _PER_SAMPLE.items():
        if key in metric.replace("-", "_"):
            return n
    return 1


def _means(totals: dict, n_total: int, divisor=_divisor) -> dict:
    return {m: (totals[m] / (n_total * divisor(m)) if n_total else np.nan)
            for m in totals} | {"num_players": n_total}


def evaluate_model(assets: SMPLAssets, image_root: str, proxy_root: str,
                   target_root: str, state: TrainState,
                   max_players: int = cfg.MAX_PLAYERS_PER_FRAME) -> dict:
    """Eval pass over every scene on the state's device: the mean of each
    tracked metric per player and element against the pseudo-GT."""
    dev = state.device
    assets = on_device(assets, dev)
    eval_step = make_eval_step()
    totals = {m: 0.0 for m in TRACKED_METRICS}
    n_total = 0
    for b in gather_scene_batches(image_root, proxy_root, target_root,
                                  max_players):
        _, aux = eval_step(state, assets, _device_batch(b, dev))
        for k, v in _metric_sums(aux, b["mask"]).items():
            totals[k] = totals.get(k, 0.0) + v
        n_total += b["num_real"]
    return _means(totals, n_total)


def _load_boxes(boxes_root: Optional[str], game: str, scene: str,
                max_players: int) -> np.ndarray:
    """The scene's first ``max_players`` boxes, padded with [0, 0, 1, 1];
    unit boxes at the origin where there is no boxes tree or file."""
    if boxes_root:
        path = os.path.join(boxes_root, game, scene, "boxes.xml")
        if os.path.exists(path):
            boxes = io.read_boxes(path)[:max_players].astype(np.float32)
            if len(boxes) < max_players:
                boxes = np.concatenate([boxes, np.tile(
                    [[0, 0, 1, 1]], (max_players - len(boxes), 1))])
            return boxes.astype(np.float32)
    return np.tile(np.array([[0, 0, 1, 1]], np.float32), (max_players, 1))


@torch.no_grad()
def evaluate_model_relate(assets: SMPLAssets, image_root: str,
                          proxy_root: str, target_root: str,
                          state: TrainState,
                          relation: Optional[PoseRelationModule] = None,
                          boxes_root: Optional[str] = None,
                          optimize_cam: bool = False,
                          relation_kwargs: Optional[dict] = None,
                          max_players: int = cfg.MAX_PLAYERS_PER_FRAME,
                          allow_random_init: bool = False,
                          gen: Optional[torch.Generator] = None) -> dict:
    """The relation module's evaluation on the state's device: per scene
    the regressor (eval mode) → the relation module's refinement of the
    batch's rotmats over the scene's boxes (``<boxes_root>/<game>/<scene>/
    boxes.xml``) → optionally ``broad_view_fit`` of [orient, camera] per
    player (50 iterations, lr 0.01, joints only, zero silhouettes) → the
    tracked metrics against the pseudo-GT.

    ``relation`` (v0, or v1 with ``train/relation.py:V1_KWARGS``) is
    required: random weights give numbers that look like metrics and mean
    nothing, so they are an error unless ``allow_random_init=True``, and
    then they come from flax's initialisers drawn from ``gen`` (a CPU
    generator; seed 0 if None) for a module built from
    ``relation_kwargs``.
    """
    from soccerplayershapepose_torch.fit import FitConfig, broad_view_fit
    from soccerplayershapepose_torch.models.ief import default_initial_params
    from soccerplayershapepose_torch.models.init import flax_init_
    from soccerplayershapepose_torch.ops.rotations import rot6d_to_rotmat
    from soccerplayershapepose_torch.smpl.model import (
        smpl_forward, smpl_shape_only)

    dev = state.device
    assets = on_device(assets, dev)
    if relation is None:
        if not allow_random_init:
            raise ValueError(
                "evaluate_model_relate needs trained relation weights: pass "
                "relation (e.g. convert.load_relation_weights(path) or "
                "io.torch_import.load_relation_checkpoint(path)). Random "
                "init is only meaningful for smoke tests; opt in with "
                "allow_random_init=True.")
        relation = flax_init_(PoseRelationModule(**(relation_kwargs or {})),
                              gen or torch.Generator().manual_seed(0))
    relation = relation.to(dev).eval()
    regressor = state.regressor.eval()
    init = default_initial_params(assets.mean_pose_rot6d, assets.mean_shape)
    fit_cfg = FitConfig(iters=50, lr=0.01, use_silhouette=False,
                        silhouette_metrics=False)

    totals = {m: 0.0 for m in TRACKED_METRICS}
    n_total = 0
    for b in gather_scene_batches(image_root, proxy_root, target_root,
                                  max_players):
        db = _device_batch(b, dev)
        boxes = torch.from_numpy(_load_boxes(
            boxes_root, b["game"], b["scene"], max_players)).to(dev)
        cam_wp, pose6d, betas = regressor(db["proxy"], init)
        rotmats = rot6d_to_rotmat(pose6d.reshape(-1, cfg.NUM_JOINTS, 6))
        rotmats = relation(rotmats[None], boxes[None],
                           db["mask"][None].bool())[0]
        if optimize_cam:
            with torch.enable_grad():
                res = broad_view_fit(
                    assets, rotmats[:, 1:], betas, rotmats[:, :1], cam_wp,
                    torch.zeros(rotmats.shape[:1] + (512, 512), device=dev),
                    db["joints2d"], fit_cfg, mask=db["mask"], device=dev)
            rotmats = torch.cat([res.global_orient, res.body_pose], dim=1)
            cam_wp = res.cam_wp
        pred = smpl_forward(assets, betas, rotmats[:, 1:], rotmats[:, :1])
        target = smpl_forward(assets, db["target_betas"],
                              db["target_pose"][:, 1:],
                              db["target_pose"][:, :1])
        aux = {"pred": {"verts": pred.vertices, "joints3D": pred.joints,
                        "betas": betas, "pose_rotmats": rotmats,
                        "reposed_verts": smpl_shape_only(assets, betas)},
               "target": {"verts": target.vertices,
                          "joints3D": target.joints,
                          "betas": db["target_betas"],
                          "pose_rotmats": db["target_pose"],
                          "reposed_verts": smpl_shape_only(
                              assets, db["target_betas"])}}
        for k, v in _metric_sums(aux, b["mask"]).items():
            totals[k] = totals.get(k, 0.0) + v
        n_total += b["num_real"]
    return _means(totals, n_total, _divisor_relate)
