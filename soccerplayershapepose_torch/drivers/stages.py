"""Folder-tree stage drivers: the reference's public API, batched on the card.

Counterpart of ``soccerplayershapepose_tpu/drivers/stages.py``: the same
input and output folder layouts and file formats (``io/formats.py``), the
same stage semantics (init/opt metric means, the refine gate on the
multi-view ``metrics.xml``, resumable per-view results). Every stage
gathers the player-views of the tree into batches of ``batch_size``
(the last one padded by repeating its last row; a mask keeps the padded
rows out of the losses and the sums), runs the port's fit on ``device``
(None: the CUDA card; the silhouette renders go to K1/K2 there) and
scatters the results back to files.

The JAX package's quirks are kept: single-view writes a per-player
``metrics.xml`` that the player's last view overwrites; player '1' (the
camera-man crop) is skipped where the JAX stages skip it; the camera of a
stored fit is ``2f / (proxy_wh · t_z + 1e-9)``, computed in numpy float32
on the host as JAX computes it. The regressor is ``regressor_fn(assets,
silhouette, joints2d)`` → :class:`~soccerplayershapepose_torch.pipeline.
predict.PredictOutput` (``pipeline/predict.py:build_predictor``'s
function; the seeded random one when None).

With ``mesh`` (``parallel/mesh.py``) the three fit stages run on every
rank of the grid: each rank gathers the same batches, pads each to
``batch_size`` as always, runs the regressor on the whole batch and fits
its slice of the players (``fit/engine.py:run_fit_loop``), and gets every
player's result back; only rank 0 writes files. Every rank returns the
same metric means. ``batch_size`` must be a multiple of the data axis: the
fit raises ``ValueError`` otherwise, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.fit import (
    FitConfig, FitInit, MultiViewInit, broad_view_fit, fit_metrics,
    multi_view_fit, single_view_fit)
from soccerplayershapepose_torch.io import formats as io
from soccerplayershapepose_torch.pipeline.predict import (
    build_predictor, on_device)
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, default_device)


# ---------------------------------------------------------------------------
# Gather: folder tree → padded arrays
# ---------------------------------------------------------------------------

def load_proxy_batch(proxy_dir: str, view_names: Iterable[str]
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Load (<view>_sil.npy, <view>_j2d.xml) pairs → (silhouettes, joints)."""
    sils, joints = [], []
    for view in view_names:
        stem = os.path.join(proxy_dir, os.path.splitext(view)[0])
        sils.append(np.load(stem + "_sil.npy"))
        joints.append(io.read_joints2d(stem + "_j2d.xml"))
    return np.stack(sils).astype(np.float32), np.stack(joints).astype(np.float32)


def _gather_views(image_root: str, proxy_root: str,
                  ignore_first: bool = True,
                  refine_filter: Optional[Callable[[io.PlayerTree], bool]] = None,
                  skip_existing_root: Optional[str] = None,
                  skip_existing_name: Optional[str] = None
                  ) -> List[Tuple[io.PlayerTree, str]]:
    """All (player, view) pairs with available proxies.

    ``ignore_first`` skips player id '1' (the camera-man crop).
    ``skip_existing_root`` makes a stage resumable at player-view
    granularity: a view whose result exists there is left out.
    """
    out = []
    for node in io.walk_player_tree(image_root):
        if ignore_first and node.player == "1":
            continue
        if refine_filter is not None and not refine_filter(node):
            continue
        proxy_dir = os.path.join(proxy_root, node.game, node.scene, node.player)
        for view in node.views:
            stem = os.path.join(proxy_dir, os.path.splitext(view)[0])
            if not (os.path.exists(stem + "_sil.npy")
                    and os.path.exists(stem + "_j2d.xml")):
                continue
            if skip_existing_root is not None:
                done = os.path.join(
                    skip_existing_root, node.game, node.scene, node.player,
                    skip_existing_name or
                    (os.path.splitext(view)[0] + ".npz"))
                if os.path.exists(done):
                    continue
            out.append((node, view))
    return out


def _refine_gate(mul_folder: str, score_thresh: float
                 ) -> Callable[[io.PlayerTree], bool]:
    """is_refine gating: only players whose multi-view metrics.xml joint
    error is ≥ score_thresh (or who have none) are reprocessed."""
    def check(node: io.PlayerTree) -> bool:
        path = os.path.join(mul_folder, node.game, node.scene, node.player,
                            "metrics.xml")
        if not os.path.exists(path):
            return True
        _, err = io.read_metrics(path)
        return err >= score_thresh
    return check


def _batched(items: Sequence, batch_size: int):
    for i in range(0, len(items), batch_size):
        yield items[i:i + batch_size]


def _pad_batch(arrays: List[np.ndarray], batch_size: int) -> np.ndarray:
    arr = np.stack(arrays)
    pad = batch_size - len(arrays)
    if pad:
        arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
    return arr


def _writes(mesh) -> bool:
    """Whether this rank writes the stage's files (rank 0 of a mesh)."""
    return mesh is None or mesh.rank == 0


def _dev_batch(rows: List[np.ndarray], batch_size: int,
               dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(_pad_batch(rows, batch_size)).to(dev)


def _load_views(proxy_root: str, chunk) -> Tuple[list, list]:
    sils, joints = [], []
    for node, view in chunk:
        s, j = load_proxy_batch(
            os.path.join(proxy_root, node.game, node.scene, node.player),
            [view])
        sils.append(s[0])
        joints.append(j[0])
    return sils, joints


def _mask(n_real: int, batch_size: int, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        (np.arange(batch_size) < n_real).astype(np.float32)).to(dev)


def _cam_from_translation(t: np.ndarray, proxy_wh: int) -> list:
    """The weak-perspective camera of a stored (3,) float32 translation,
    in numpy float32 as the JAX stages compute it."""
    return [2 * cfg.FOCAL_LENGTH / (proxy_wh * t[2] + 1e-9), t[0], t[1]]


def _host(*xs: torch.Tensor) -> List[np.ndarray]:
    return [x.detach().cpu().numpy() for x in xs]


def _setup(assets: SMPLAssets, regressor_fn, device: DeviceLike,
           need_regressor: bool = True):
    dev = default_device(device)
    if need_regressor and regressor_fn is None:
        _, regressor_fn = build_predictor(device=dev)
    return dev, on_device(assets, dev), regressor_fn


def _fit_init(pred) -> FitInit:
    return FitInit(body_pose=pred.pose_rotmats[:, 1:],
                   global_orient=pred.pose_rotmats[:, :1],
                   betas=pred.betas, cam_wp=pred.cam_wp)


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------

def predict_stage(assets: SMPLAssets, proxy_root: str, image_root: str,
                  result_root: str, regressor_fn=None, batch_size: int = 32,
                  device: DeviceLike = None) -> int:
    """Regressor forward over every player-view; writes per-view ``.npz``
    fit-format files. Returns the number of views processed."""
    dev, assets, regressor_fn = _setup(assets, regressor_fn, device)
    pairs = _gather_views(image_root, proxy_root, ignore_first=False)
    count = 0
    for chunk in _batched(pairs, batch_size):
        sils, joints = _load_views(proxy_root, chunk)
        sil_b = _dev_batch(sils, batch_size, dev)
        j2d_b = _dev_batch(joints, batch_size, dev)
        out = regressor_fn(assets, sil_b, j2d_b)
        orient, body_pose, betas, transl = _host(
            out.pose_rotmats[:, :1], out.pose_rotmats[:, 1:], out.betas,
            out.translation)
        for i, (node, view) in enumerate(chunk):
            out_dir = os.path.join(result_root, node.game, node.scene,
                                   node.player)
            os.makedirs(out_dir, exist_ok=True)
            io.write_fit_npz(
                os.path.join(out_dir, os.path.splitext(view)[0] + ".npz"),
                body_pose[i], orient[i], betas[i], transl[i])
            count += 1
    return count


def single_view_optimization(assets: SMPLAssets, image_root: str,
                             proxy_root: str, result_root: str,
                             regressor_fn=None,
                             fit_cfg: Optional[FitConfig] = None,
                             batch_size: int = 32,
                             is_refine: bool = False,
                             score_thresh: float = cfg.REFINE_SCORE_THRESH,
                             mul_folder: Optional[str] = None,
                             ignore_first: bool = True,
                             skip_existing: bool = False,
                             vis_folder: Optional[str] = None,
                             verbose: bool = True,
                             device: DeviceLike = None,
                             mesh=None) -> dict:
    """Batched single-view fitting over the player tree: writes per-view
    ``.npz`` results and the player's ``metrics.xml`` [silh_iou,
    joint_err] (its last view's), and returns the init/opt metric means.
    ``skip_existing`` resumes an interrupted run at player-view
    granularity; ``vis_folder`` writes each view's best-iterate mesh
    overlay over its proxy silhouette as ``<view>_1.png``. ``mesh``
    shards each batch's players over the data axis (module docstring)."""
    fit_cfg = fit_cfg or FitConfig()
    dev, assets, regressor_fn = _setup(assets, regressor_fn, device)
    writes = _writes(mesh)

    refine_filter = _refine_gate(mul_folder, score_thresh) \
        if (is_refine and mul_folder) else None
    pairs = _gather_views(image_root, proxy_root, ignore_first, refine_filter,
                          skip_existing_root=result_root if skip_existing
                          else None)

    sums = {"init_iou": 0.0, "init_err": 0.0, "opt_iou": 0.0, "opt_err": 0.0}
    count = 0
    for chunk in _batched(pairs, batch_size):
        sils, joints = _load_views(proxy_root, chunk)
        sil_np = _pad_batch(sils, batch_size)
        sil_b = torch.from_numpy(sil_np).to(dev)
        j2d_b = _dev_batch(joints, batch_size, dev)
        mask = _mask(len(chunk), batch_size, dev)

        pred = regressor_fn(assets, sil_b, j2d_b)
        res = single_view_fit(assets, _fit_init(pred), sil_b, j2d_b, fit_cfg,
                              mask, device=dev, mesh=mesh)
        body_pose, orient, betas, transl, iou, err, iou0, err0 = _host(
            res.body_pose, res.global_orient, res.betas, res.translation,
            res.silh_iou, res.joint_err, res.init_silh_iou,
            res.init_joint_err)

        if vis_folder is not None and writes:
            from soccerplayershapepose_torch.render.vis import (
                render_mesh_overlay)
            from soccerplayershapepose_torch.smpl.model import smpl_forward
            with torch.no_grad():
                best = smpl_forward(assets, res.betas, res.body_pose,
                                    res.global_orient)
        for i, (node, view) in enumerate(chunk if writes else []):
            out_dir = os.path.join(result_root, node.game, node.scene,
                                   node.player)
            os.makedirs(out_dir, exist_ok=True)
            io.write_fit_npz(
                os.path.join(out_dir, os.path.splitext(view)[0] + ".npz"),
                body_pose[i], orient[i], betas[i], transl[i])
            # The player's score for the refine gate and calc_metrics; on
            # a multi-view tree its last view's overwrites the others'.
            io.write_metrics(os.path.join(out_dir, "metrics.xml"),
                             float(iou[i]), float(err[i]))
            if vis_folder is not None:
                vis_dir = os.path.join(vis_folder, node.game, node.scene,
                                       node.player)
                os.makedirs(vis_dir, exist_ok=True)
                base = (sil_np[i] * 128).astype(np.uint8)
                base = np.stack([base] * 3, axis=-1)
                overlay = render_mesh_overlay(
                    best.vertices[i], assets.faces, res.cam_wp[i], base)
                io.write_png(os.path.join(
                    vis_dir, os.path.splitext(view)[0] + "_1.png"), overlay)
        for i in range(len(chunk)):
            sums["init_iou"] += float(iou0[i])
            sums["init_err"] += float(err0[i])
            sums["opt_iou"] += float(iou[i])
            sums["opt_err"] += float(err[i])
            count += 1

    result = {k: (v / count if count else float("nan"))
              for k, v in sums.items()}
    result["count"] = count
    if verbose and count:
        print(f"silh_iou_init: {result['init_iou']}, "
              f"joint_error_init: {result['init_err']}")
        print(f"silh_iou_opt: {result['opt_iou']}, "
              f"joint_error_opt: {result['opt_err']}")
    return result


def single_view_optimization_test(assets: SMPLAssets, image_root: str,
                                  proxy_root: str, result_root: str,
                                  regressor_fn=None,
                                  fit_cfg: Optional[FitConfig] = None,
                                  batch_size: int = 32,
                                  snapshot_every: int = 1,
                                  save_every: bool = True,
                                  ignore_first: bool = True,
                                  device: DeviceLike = None) -> dict:
    """Ablation variant of the single-view stage: the kept iterate updates
    every iteration (``save_every``) and the parameter trajectory is
    written as ``<view>_epoch{k}.npz`` snapshots every ``snapshot_every``
    iterations, next to the final ``<view>.npz``."""
    fit_cfg = dataclasses.replace(fit_cfg or FitConfig(),
                                  save_every=save_every,
                                  snapshot_every=snapshot_every)
    dev, assets, regressor_fn = _setup(assets, regressor_fn, device)
    pairs = _gather_views(image_root, proxy_root, ignore_first, None, None)

    count = 0
    for chunk in _batched(pairs, batch_size):
        sils, joints = _load_views(proxy_root, chunk)
        sil_b = _dev_batch(sils, batch_size, dev)
        j2d_b = _dev_batch(joints, batch_size, dev)
        mask = _mask(len(chunk), batch_size, dev)

        pred = regressor_fn(assets, sil_b, j2d_b)
        res = single_view_fit(assets, _fit_init(pred), sil_b, j2d_b, fit_cfg,
                              mask, device=dev)
        body_pose, orient, betas, transl = _host(
            res.body_pose, res.global_orient, res.betas, res.translation)
        snaps = {k: v.detach().cpu().numpy()
                 for k, v in res.snapshots.items()}

        for i, (node, view) in enumerate(chunk):
            out_dir = os.path.join(result_root, node.game, node.scene,
                                   node.player)
            os.makedirs(out_dir, exist_ok=True)
            base = os.path.splitext(view)[0]
            io.write_fit_npz(os.path.join(out_dir, base + ".npz"),
                             body_pose[i], orient[i], betas[i], transl[i])
            for t in range(snaps["body_pose"].shape[0]):
                io.write_fit_npz(
                    os.path.join(out_dir,
                                 f"{base}_epoch{t * snapshot_every + 1}.npz"),
                    snaps["body_pose"][t, i], snaps["global_orient"][t, i],
                    snaps["betas"][t, i], snaps["translation"][t, i])
            count += 1
    return {"count": count,
            "snapshots_per_view": 0 if not count
            else (fit_cfg.iters + snapshot_every - 1) // snapshot_every}


def multi_view_optimization(assets: SMPLAssets, image_root: str,
                            proxy_root: str, single_view_root: str,
                            result_root: str,
                            fit_cfg: Optional[FitConfig] = None,
                            batch_size: int = 8,
                            ignore_first: bool = True,
                            verbose: bool = True,
                            rounds: int = cfg.MULTI_VIEW_ROUNDS,
                            iters_per_phase: int = cfg.MULTI_VIEW_ITERS,
                            device: DeviceLike = None,
                            mesh=None) -> dict:
    """Batched multi-view fitting from the single-view results: writes the
    shared ``data.npz``, a ``<view>.npz`` per view and ``metrics.xml`` per
    player. A player with fewer views than the tree's most repeats its
    last view. ``rounds`` × (``iters_per_phase`` camera + pose) is the
    3 × (50 + 50) reference budget. ``mesh`` shards each batch's players
    over the data axis (module docstring)."""
    fit_cfg = fit_cfg or FitConfig(iters=cfg.MULTI_VIEW_ITERS)
    dev, assets, _ = _setup(assets, None, device, need_regressor=False)
    writes = _writes(mesh)

    players = []
    for node in io.walk_player_tree(image_root):
        if ignore_first and node.player == "1":
            continue
        sv_dir = os.path.join(single_view_root, node.game, node.scene,
                              node.player)
        if not os.path.isdir(sv_dir):
            continue
        views = [v for v in node.views if os.path.exists(
            os.path.join(sv_dir, os.path.splitext(v)[0] + ".npz"))]
        if views:
            players.append((node, views))

    n_views = max((len(v) for _, v in players), default=0)
    sums = {"iou": 0.0, "err": 0.0}
    count = 0
    for chunk in _batched(players, batch_size):
        init_bp, init_go, init_be, init_cam, sil_l, j2d_l = \
            [], [], [], [], [], []
        for node, views in chunk:
            sv_dir = os.path.join(single_view_root, node.game, node.scene,
                                  node.player)
            proxy_dir = os.path.join(proxy_root, node.game, node.scene,
                                     node.player)
            s, j = load_proxy_batch(proxy_dir, views)
            bp, go, be, cw = [], [], [], []
            for v in views:
                d = io.read_fit_npz(
                    os.path.join(sv_dir, os.path.splitext(v)[0] + ".npz"))
                bp.append(d["body_pose"][0])
                go.append(d["global_orient"][0])
                be.append(d["betas"][0])
                cw.append(_cam_from_translation(d["translation"][0],
                                                fit_cfg.proxy_wh))

            def pad_views(x):
                x = np.asarray(x, np.float32)
                if len(x) < n_views:
                    x = np.concatenate(
                        [x, np.repeat(x[-1:], n_views - len(x), axis=0)])
                return x
            init_bp.append(pad_views(bp))
            init_go.append(pad_views(go))
            init_be.append(pad_views(be))
            init_cam.append(pad_views(cw))
            sil_l.append(pad_views(s))
            j2d_l.append(pad_views(j))

        init = MultiViewInit(
            body_pose=_pad_batch(init_bp, batch_size),
            global_orient=_pad_batch(init_go, batch_size),
            betas=_pad_batch(init_be, batch_size),
            cam_wp=_pad_batch(init_cam, batch_size))
        res = multi_view_fit(assets, init, _pad_batch(sil_l, batch_size),
                             _pad_batch(j2d_l, batch_size), fit_cfg,
                             rounds=rounds, iters_per_phase=iters_per_phase,
                             mask=_mask(len(chunk), batch_size, dev),
                             device=dev, mesh=mesh)
        body_pose, betas, transl, orient, iou, err = _host(
            res.body_pose, res.betas, res.translation, res.global_orient,
            res.silh_iou, res.joint_err)

        for i, (node, views) in enumerate(chunk):
            out_dir = os.path.join(result_root, node.game, node.scene,
                                   node.player)
            per_view = {os.path.splitext(v)[0]: {
                "translation": transl[i, vi],
                "global_orient": orient[i, vi]}
                for vi, v in enumerate(views)}
            if writes:
                io.write_multiview_npz(out_dir, body_pose[i], betas[i],
                                       per_view)
                io.write_metrics(os.path.join(out_dir, "metrics.xml"),
                                 float(iou[i]), float(err[i]))
            sums["iou"] += float(iou[i])
            sums["err"] += float(err[i])
            count += 1

    result = {"iou": sums["iou"] / count if count else float("nan"),
              "err": sums["err"] / count if count else float("nan"),
              "count": count}
    if verbose and count:
        print(f"multi-view: silh_iou {result['iou']}, "
              f"joint_error {result['err']} over {count} players")
    return result


def broad_view_optimization(assets: SMPLAssets, broad_image_root: str,
                            broad_proxy_root: str, multi_view_root: str,
                            result_root: str, regressor_fn=None,
                            fit_cfg: Optional[FitConfig] = None,
                            batch_size: int = 32,
                            is_refine: bool = False,
                            score_thresh: float = cfg.REFINE_SCORE_THRESH,
                            verbose: bool = True,
                            device: DeviceLike = None,
                            mesh=None) -> dict:
    """Broadcast transfer: pose and shape frozen from the multi-view
    result, [camera, orient] fitted per player on the broadcast proxy
    from the regressor's init; writes ``data.npz`` and ``metrics.xml``.
    ``is_refine`` refits only players whose own ``metrics.xml`` under
    ``result_root`` has joint error ≥ ``score_thresh``. ``mesh`` shards
    each batch's players over the data axis (module docstring)."""
    fit_cfg = fit_cfg or FitConfig(iters=cfg.BROAD_VIEW_ITERS,
                                   lr=cfg.BROAD_VIEW_LR)
    dev, assets, regressor_fn = _setup(assets, regressor_fn, device)
    writes = _writes(mesh)

    refine_filter = _refine_gate(result_root, score_thresh) if is_refine \
        else None
    pairs = _gather_views(broad_image_root, broad_proxy_root,
                          ignore_first=False, refine_filter=refine_filter)
    # Only players with a multi-view result.
    pairs = [(n, v) for n, v in pairs if os.path.exists(
        os.path.join(multi_view_root, n.game, n.scene, n.player, "data.npz"))]

    sums = {"init_iou": 0.0, "init_err": 0.0, "opt_iou": 0.0, "opt_err": 0.0}
    count = 0
    for chunk in _batched(pairs, batch_size):
        sils, joints = _load_views(broad_proxy_root, chunk)
        bps, bes = [], []
        for node, _ in chunk:
            mv = io.read_multiview_npz(
                os.path.join(multi_view_root, node.game, node.scene,
                             node.player))
            bps.append(mv["body_pose"][0])
            bes.append(mv["betas"][0])

        sil_b = _dev_batch(sils, batch_size, dev)
        j2d_b = _dev_batch(joints, batch_size, dev)
        mask = _mask(len(chunk), batch_size, dev)

        pred = regressor_fn(assets, sil_b, j2d_b)
        res = broad_view_fit(
            assets, _pad_batch(bps, batch_size), _pad_batch(bes, batch_size),
            pred.pose_rotmats[:, :1], pred.cam_wp, sil_b, j2d_b,
            fit_cfg, mask, device=dev, mesh=mesh)
        body_pose, orient, betas, transl, iou, err, iou0, err0 = _host(
            res.body_pose, res.global_orient, res.betas, res.translation,
            res.silh_iou, res.joint_err, res.init_silh_iou,
            res.init_joint_err)

        for i, (node, view) in enumerate(chunk):
            out_dir = os.path.join(result_root, node.game, node.scene,
                                   node.player)
            if writes:
                os.makedirs(out_dir, exist_ok=True)
                io.write_fit_npz(os.path.join(out_dir, "data.npz"),
                                 body_pose[i], orient[i], betas[i],
                                 transl[i])
                io.write_metrics(os.path.join(out_dir, "metrics.xml"),
                                 float(iou[i]), float(err[i]))
            sums["init_iou"] += float(iou0[i])
            sums["init_err"] += float(err0[i])
            sums["opt_iou"] += float(iou[i])
            sums["opt_err"] += float(err[i])
            count += 1

    result = {k: (v / count if count else float("nan"))
              for k, v in sums.items()}
    result["count"] = count
    if verbose and count:
        print(f"broad: silh_iou {result['init_iou']} -> {result['opt_iou']}, "
              f"joint_error {result['init_err']} -> {result['opt_err']}")
    return result


def calc_initial_metrics(assets: SMPLAssets, image_root: str, proxy_root: str,
                         result_root: str, fit_cfg: Optional[FitConfig] = None,
                         batch_size: int = 32,
                         device: DeviceLike = None) -> dict:
    """The metrics of stored per-view fit results against their proxies
    (no optimisation; the silhouette through K1 alone on the card)."""
    fit_cfg = fit_cfg or FitConfig()
    dev, assets, _ = _setup(assets, None, device, need_regressor=False)

    pairs = _gather_views(image_root, proxy_root, ignore_first=False)
    pairs = [(n, v) for n, v in pairs if os.path.exists(os.path.join(
        result_root, n.game, n.scene, n.player,
        os.path.splitext(v)[0] + ".npz"))]

    def dev_batch(rows):
        return _dev_batch(rows, batch_size, dev)

    total_iou, total_err, count = 0.0, 0.0, 0
    for chunk in _batched(pairs, batch_size):
        sils, joints = _load_views(proxy_root, chunk)
        inits = [io.read_fit_npz(os.path.join(
            result_root, node.game, node.scene, node.player,
            os.path.splitext(view)[0] + ".npz")) for node, view in chunk]
        n_real = len(chunk)
        init = FitInit(
            body_pose=dev_batch([d["body_pose"][0] for d in inits]),
            global_orient=dev_batch([d["global_orient"][0] for d in inits]),
            betas=dev_batch([d["betas"][0] for d in inits]),
            cam_wp=dev_batch([_cam_from_translation(
                d["translation"][0], fit_cfg.proxy_wh) for d in inits]))
        m = fit_metrics(assets, init, dev_batch(sils), dev_batch(joints),
                        fit_cfg)
        iou, err = _host(m["silh_iou"], m["joint_err"])
        total_iou += float(iou[:n_real].sum())
        total_err += float(err[:n_real].sum())
        count += n_real

    return {"silh_iou": total_iou / count if count else float("nan"),
            "joint_err": total_err / count if count else float("nan"),
            "count": count}
