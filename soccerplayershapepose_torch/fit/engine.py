"""Shared machinery of the render-and-compare fitting loops.

Counterpart of ``soccerplayershapepose_tpu/fit/engine.py``: SMPL forward →
weak-perspective joint projection → soft-silhouette render → homoscedastic
joints2D (+ silhouette) loss → Adam step → metrics → best-iterate
bookkeeping, batched over players. The reference's quirks are kept:

* rotation matrices are optimised as free 3×3 tensors;
* the loss log-variances stay fixed at their initial values;
* joints2D in the loss are normalised by 256 although they live in 512 px;
* an iterate is kept iff every tracked metric (mean 2D joint L2 and the
  silhouette BCE score) is ≤ the best so far, and the kept parameters are
  the ones that iterate was evaluated at, before its Adam update;
* the reported joint error truncates the predicted keypoints to integers.

The loop runs on the device of its inputs. It renders the silhouette once
per iteration, so on CUDA each of the two band kernels launches once per
iteration. On the CPU, and on CUDA where :func:`graph_engages` says no, it
is a plain Python loop. Otherwise the first iteration runs eagerly and the
rest replay one CUDA graph of the same iteration (:class:`_GraphPlan`),
captured once for a plan of inputs and kept for later calls: one launch an
iteration where the eager loop makes hundreds, so the card, not the host,
sets the pace. ``iters_per_call`` (a TPU-worker workaround in the JAX
package) is accepted and has no effect.

With ``mesh`` (``parallel/mesh.py``) every rank gets the global batch and
fits its slice of the rows (and groups) over the data axis; the kernels
launch at the rank's rows. The fit is not free of cross-row terms, so the
ranks meet where the global batch meets:

* the joints-2D term is a mean over every row's joints, or over the
  visibility sum; the priors are means over every row. One all-reduce of
  the local counts before the loop turns each local mean into the rank's
  share of the global one;
* with a prior on, every row's prior gradient scales with ``|total|`` of
  the whole batch: one scalar all-reduce per iteration. Each rank's loss
  holds its share of the log-variance terms (1 / data axis), so their sum
  counts them once;
* at the end one all-gather returns every row's result on every rank.

Adam is elementwise and the best-iterate choice is per group, so both
stay local.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import torch

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.losses.multi_task import (
    MultiTaskLossConfig, init_loss_state, multi_task_loss)
from soccerplayershapepose_torch.ops.camera import (
    orthographic_project, undo_keypoint_normalisation,
    weak_perspective_to_translation)
from soccerplayershapepose_torch.ops.segmentation import (
    silhouette_confusion_metrics)
from soccerplayershapepose_torch.parallel.collectives import (
    all_reduce_sum, data_parallel, data_sum, gather_dict_rows)
from soccerplayershapepose_torch.parallel.mesh import data_sharding
from soccerplayershapepose_torch.render import band_raster
from soccerplayershapepose_torch.render.softras import render_silhouette
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.smpl.model import smpl_forward
from soccerplayershapepose_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class FitConfig:
    iters: int = cfg.SINGLE_VIEW_ITERS
    lr: float = cfg.FITTING_LR
    use_silhouette: bool = True
    proxy_wh: int = cfg.PROXY_REP_INPUT_WH
    render_wh: int = cfg.PROXY_REP_INPUT_WH   # lower for speed
    sigma: float = 1e-5
    focal_length: float = cfg.FOCAL_LENGTH
    # Render for the metrics even when the silhouette loss is off; False
    # skips the render (metrics report 0).
    silhouette_metrics: bool = True
    # Accepted for the JAX package's signature; no effect here.
    iters_per_call: Optional[int] = 10
    # Faces per step of the plain (CPU) rasterizer.
    faces_per_chunk: int = 16
    # Drop back faces before rasterizing (the top 60% by signed area stay).
    backface_cull: bool = True
    # Relative priors (0 = reference parity): each term is scaled by the
    # detached |main loss|, so a weight means a share of the current loss.
    joint_conf_weighting: bool = False
    betas_prior: float = 0.0
    pose_prior: float = 0.0
    rot_ortho_prior: float = 0.0
    joints2d_scale: float = 1.0
    silh_warmup_iters: int = 0
    # Keep every iterate (bypass the all-metrics-improve rule); optionally
    # return the parameter trajectory sampled every K iterations.
    save_every: bool = False
    snapshot_every: Optional[int] = None


class FitInit(NamedTuple):
    """Initial SMPL state per player."""
    body_pose: torch.Tensor      # (B, 23, 3, 3)
    global_orient: torch.Tensor  # (B, 1, 3, 3)
    betas: torch.Tensor          # (B, 10)
    cam_wp: torch.Tensor         # (B, 3)


class FitResult(NamedTuple):
    body_pose: torch.Tensor      # (B, 23, 3, 3) best iterate
    global_orient: torch.Tensor  # (B, 1, 3, 3)
    betas: torch.Tensor          # (B, 10)
    cam_wp: torch.Tensor         # (B, 3)
    translation: torch.Tensor    # (B, 3)
    silh_iou: torch.Tensor       # (B,) best-iterate silhouette IoU
    joint_err: torch.Tensor      # (B,) best-iterate joint px error (int-cast)
    init_silh_iou: torch.Tensor  # (B,) metrics at iteration 1
    init_joint_err: torch.Tensor
    best_iter: torch.Tensor      # (B,) 1-based iteration of the best
    snapshots: Optional[dict] = None


def make_loss_state(use_silhouette: bool, device="cpu"):
    losses_on = ["joints2D"] + (["silhouette"] if use_silhouette else [])
    return tuple(losses_on), init_loss_state(
        losses_on, cfg.FITTING_INIT_LOSS_WEIGHTS, device=device)


def downsample_target(target_silhouette: torch.Tensor,
                      render_wh: int) -> torch.Tensor:
    """Box-filter (area-average) the target down to ``render_wh``; strided
    subsampling would drop 1-2 px structures such as arms."""
    full = target_silhouette.shape[-1]
    if render_wh == full:
        return target_silhouette
    if full % render_wh != 0:
        raise ValueError(f"render_wh={render_wh} must divide the target "
                         f"silhouette size {full}")
    step = full // render_wh
    lead = target_silhouette.shape[:-2]
    return target_silhouette.reshape(
        *lead, render_wh, step, render_wh, step).mean(dim=(-3, -1))


@functools.lru_cache(maxsize=None)
def _keypoint_index(device: torch.device) -> torch.Tensor:
    """``SMPL_TO_KPRCNN_MAP`` on ``device``, built once: a copy from the
    host in every iteration would make the host wait, and a CUDA graph
    cannot hold one. Read-only."""
    return torch.as_tensor(cfg.SMPL_TO_KPRCNN_MAP, device=device)


def evaluate_fit(assets: SMPLAssets, body_pose, global_orient, betas, cam_wp,
                 target_silhouette, target_joints2d, fit_cfg: FitConfig):
    """One forward evaluation: loss inputs and metrics.

    Returns a dict with pred_j2d (float px), pred_sil (render_wh²),
    target_sil, iou, joint_err (int-cast), bce_score, translation and
    vertices.
    """
    out = smpl_forward(assets, betas, body_pose, global_orient)
    j2d = orthographic_project(out.joints, cam_wp)[:, _keypoint_index(
        betas.device)]
    j2d = undo_keypoint_normalisation(j2d, fit_cfg.proxy_wh)
    translation = weak_perspective_to_translation(
        cam_wp, fit_cfg.focal_length, fit_cfg.proxy_wh)

    if fit_cfg.use_silhouette or fit_cfg.silhouette_metrics:
        pred_sil = render_silhouette(out.vertices, translation, assets.faces,
                                     fit_cfg.proxy_wh, fit_cfg.focal_length,
                                     sigma=fit_cfg.sigma,
                                     render_wh=fit_cfg.render_wh,
                                     backface_cull=fit_cfg.backface_cull,
                                     faces_per_chunk=fit_cfg.faces_per_chunk)
        target_sil = downsample_target(target_silhouette, fit_cfg.render_wh)
        iou = silhouette_confusion_metrics(pred_sil.detach(), target_sil)["iou"]
        bce = -torch.sum(
            pred_sil * torch.log(target_sil + 1e-6)
            + (1.0 - pred_sil) * torch.log(1.0 - target_sil + 1e-6),
            dim=(-2, -1))
    else:
        b = target_joints2d.shape[0]
        pred_sil = target_sil = torch.zeros((b, 1, 1), device=betas.device)
        iou = torch.zeros((b,), device=betas.device)
        bce = torch.zeros((b,), device=betas.device)

    joint_err = torch.mean(torch.linalg.vector_norm(
        torch.trunc(j2d) - target_joints2d[..., :2], dim=-1), dim=-1)
    return {"pred_j2d": j2d, "pred_sil": pred_sil, "target_sil": target_sil,
            "iou": iou, "joint_err": joint_err, "bce_score": bce,
            "translation": translation, "vertices": out.vertices}


class _Shares(NamedTuple):
    """A rank's share of the global batch's means (``run_fit_loop`` with a
    mesh): of the joints-2D mean and of the priors' row means; 1 and 1 in
    one process."""
    joints2d: float = 1.0
    rows: float = 1.0


def _loss(assets, params, frozen, assemble, target_silhouette,
          target_joints2d, row_mask, log_vars, loss_cfg, fit_cfg, it,
          shares: _Shares = _Shares()):
    body_pose, global_orient, betas, cam_wp = assemble(params, frozen)
    ev = evaluate_fit(assets, body_pose, global_orient, betas, cam_wp,
                      target_silhouette, target_joints2d, fit_cfg)
    m3 = row_mask[:, None, None]
    outputs = {"joints2D": ev["pred_j2d"] * m3}
    labels = {"joints2D": target_joints2d[..., :2] * m3}
    if fit_cfg.joint_conf_weighting and target_joints2d.shape[-1] >= 3:
        labels["vis"] = target_joints2d[..., 2] * row_mask[:, None]
    if fit_cfg.use_silhouette:
        outputs["silhouette"] = ev["pred_sil"] * m3
        labels["silhouette"] = ev["target_sil"] * m3
    task_scales = {}
    if fit_cfg.silh_warmup_iters and fit_cfg.use_silhouette:
        task_scales["silhouette"] = min((it + 1.0) / fit_cfg.silh_warmup_iters,
                                        1.0)
    if fit_cfg.joints2d_scale != 1.0:
        task_scales["joints2D"] = fit_cfg.joints2d_scale
    task_scales["joints2D"] = (task_scales.get("joints2D", 1.0)
                               * shares.joints2d)
    total, _ = multi_task_loss(log_vars, outputs, labels, loss_cfg,
                               task_scales)

    def row_mean(x):
        return torch.mean(x * row_mask) * shares.rows

    # Priors scale with the detached main-loss magnitude (~1e9 at reference
    # weights), or they would vanish below fp32 update resolution.
    if fit_cfg.betas_prior or fit_cfg.rot_ortho_prior or (
            fit_cfg.pose_prior and "pose_prior_ref" in frozen):
        mag = torch.abs(data_sum(total)) + 1e-8
        if fit_cfg.betas_prior:
            total = total + fit_cfg.betas_prior * mag * row_mean(
                torch.sum(betas ** 2, dim=-1))
        if fit_cfg.pose_prior and "pose_prior_ref" in frozen:
            dev = (body_pose - frozen["pose_prior_ref"]) ** 2
            total = total + fit_cfg.pose_prior * mag * row_mean(
                torch.sum(dev, dim=(-3, -2, -1)))
        if fit_cfg.rot_ortho_prior:
            rots = torch.cat([global_orient, body_pose], dim=1)
            rtr = torch.einsum("bjki,bjkl->bjil", rots, rots)
            dev = (rtr - torch.eye(3, dtype=rots.dtype,
                                   device=rots.device)) ** 2
            total = total + fit_cfg.rot_ortho_prior * mag * row_mean(
                torch.sum(dev, dim=(-2, -1)).mean(dim=-1))
    return total, ev


def _shard_fit(mesh, rows, groups, group_size, fit_cfg, trainable, frozen,
               tensors, target_joints2d):
    """This rank's slice of the fit's inputs and its :class:`_Shares`:
    trainables on the group axis, frozen tensors on whichever of the row
    or group axis leads them, ``tensors`` (targets, masks) on the rows.
    One all-reduce of the local counts."""
    n_data = mesh.n_data
    if rows % n_data or (groups % n_data if group_size > 1 else False):
        raise ValueError(
            f"rows={rows} (groups={groups}) must be a multiple of the "
            f"data axis ({n_data}); pad the scene batch")
    rs, gs = data_sharding(mesh, rows), data_sharding(mesh, groups)

    def lead(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1:
            if x.shape[0] == rows:
                return x[rs]
            if x.shape[0] == groups:
                return x[gs]
        return x

    trainable = {k: v[gs] for k, v in trainable.items()}
    frozen = {k: lead(v) for k, v in frozen.items()}
    tensors = [x[rs] for x in tensors]
    j2d = target_joints2d[rs]
    dev = j2d.device
    # The joints-2D mean's denominator: every (row, joint, axis) element,
    # or the visibility sum over them (at least 1); the priors': every row.
    vis = fit_cfg.joint_conf_weighting and j2d.shape[-1] >= 3
    if vis:
        m = tensors[0][:, None] * j2d[..., 2]          # row mask × vis
        j_local = 2.0 * torch.sum(m.to(torch.float64))
    else:
        j_local = torch.tensor(float(j2d[..., :2].numel()),
                               dtype=torch.float64, device=dev)
    local = torch.stack([j_local, torch.tensor(
        float(j2d.shape[0]), dtype=torch.float64, device=dev)])
    whole = all_reduce_sum(local, mesh.data_group)
    lo = 1.0 if vis else 0.0
    j_share = max(float(local[0]), lo) / max(float(whole[0]), lo)
    shares = _Shares(joints2d=j_share, rows=float(local[1] / whole[1]))
    return trainable, frozen, tensors, j2d, shares


class _Loop:
    """One fit's state: what an iteration reads (assets, targets, mask,
    weights, frozen tensors) and writes (the trainable leaves, Adam's state,
    the best-iterate record and the iteration counter, all in place). The
    eager loop builds one a call on the caller's tensors; a graph plan
    keeps one on buffers of its own and reloads it (:meth:`load`)."""

    def __init__(self, assets, trainable, frozen, assemble,
                 target_silhouette, target_joints2d, mask, metric_weights,
                 fit_cfg: FitConfig, group_size: int,
                 shares: _Shares = _Shares(), group=None):
        dev = target_joints2d.device
        self.assets, self.frozen, self.assemble = assets, frozen, assemble
        self.target_silhouette = target_silhouette
        self.target_joints2d = target_joints2d
        self.mask, self.metric_weights = mask, metric_weights
        self.fit_cfg, self.group_size = fit_cfg, group_size
        self.shares, self.group = shares, group
        self.groups = target_joints2d.shape[0] // group_size
        losses_on, self.log_vars = make_loss_state(fit_cfg.use_silhouette,
                                                   device=dev)
        self.loss_cfg = MultiTaskLossConfig(losses_on=losses_on)
        self.params = {k: v.detach().clone().requires_grad_(True)
                       for k, v in trainable.items()}
        # Capturable on CUDA, so that the eager and the replayed loop run
        # the same kernels (the step count stays on the card).
        self.opt = torch.optim.Adam(list(self.params.values()),
                                    lr=fit_cfg.lr, betas=(0.9, 0.999),
                                    eps=1e-8, capturable=dev.type == "cuda")

        def per_group(dtype=torch.float32):
            return torch.empty((self.groups,), dtype=dtype, device=dev)

        self.best = {"m0": per_group(), "m1": per_group(),
                     "iou": per_group(), "joint_err": per_group(),
                     "iter": per_group(torch.int32),
                     "params": {k: torch.empty_like(v)
                                for k, v in self.params.items()},
                     "init_iou": per_group(), "init_joint_err": per_group()}
        self.count = torch.empty((), dtype=torch.int32, device=dev)
        self.snaps = [] if fit_cfg.snapshot_every else None
        self._reset()

    def _reset(self) -> None:
        """The state of a fresh fit from the current parameters."""
        best = self.best
        with torch.no_grad():
            for k in ("m0", "m1"):
                best[k].fill_(float("inf"))
            for k in ("iou", "joint_err", "iter", "init_iou",
                      "init_joint_err"):
                best[k].zero_()
            for k, v in self.params.items():
                best["params"][k].copy_(v)
            self.count.zero_()
            # Adam's state (step, moments) is all zeros at the start.
            for state in self.opt.state.values():
                for t in state.values():
                    t.zero_()

    def load(self, trainable, frozen, target_silhouette, target_joints2d,
             mask, metric_weights) -> None:
        """Copy a call's inputs into this loop's buffers and reset it."""
        with torch.no_grad():
            for k, v in trainable.items():
                self.params[k].copy_(v)
            for k, v in frozen.items():
                self.frozen[k].copy_(v)
            for dst, src in ((self.target_silhouette, target_silhouette),
                             (self.target_joints2d, target_joints2d),
                             (self.mask, mask),
                             (self.metric_weights, metric_weights)):
                dst.copy_(src)
        self._reset()

    def reduce_groups(self, x):
        if self.group_size == 1:
            return x
        w = self.metric_weights.reshape(self.groups, self.group_size)
        xw = (x * self.metric_weights).reshape(self.groups, self.group_size)
        return torch.sum(xw, dim=1) / torch.clamp(torch.sum(w, dim=1),
                                                  min=1.0)

    def select(self, ev: dict, first: bool) -> None:
        """The best-iterate bookkeeping after an iteration, in place: a
        group keeps the iterate iff its every tracked metric is ≤ its best
        so far. The counter advances to the iteration's 1-based number;
        ``first`` records the initial metrics."""
        best, reduce = self.best, self.reduce_groups
        ev = {k: v.detach() for k, v in ev.items()}
        j2d_l2 = reduce(torch.mean(torch.linalg.vector_norm(
            ev["pred_j2d"] - self.target_joints2d[..., :2], dim=-1), dim=-1))
        bce = (reduce(ev["bce_score"]) if self.fit_cfg.use_silhouette
               else torch.zeros_like(j2d_l2))
        iou = reduce(ev["iou"])
        jerr = reduce(ev["joint_err"])
        improve = (j2d_l2 <= best["m0"]) & (bce <= best["m1"])
        if self.fit_cfg.save_every:
            improve = torch.ones_like(improve)
        self.count += 1

        def keep(old, new):
            cond = improve.reshape((self.groups,) + (1,) * (old.dim() - 1))
            torch.where(cond, new, old, out=old)

        for k, new in (("m0", j2d_l2), ("m1", bce), ("iou", iou),
                       ("joint_err", jerr), ("iter", self.count)):
            keep(best[k], new)
        for k, v in self.params.items():
            keep(best["params"][k], v.detach())
        if first:
            best["init_iou"].copy_(iou)
            best["init_joint_err"].copy_(jerr)

    def iterate(self, it: int) -> None:
        """Iteration ``it``: SMPL, projection, render and loss, backward,
        the best-iterate choice, Adam's step. Run eagerly, or captured
        once into the plan's graph and replayed."""
        with profiling.span("fit.forward"), data_parallel(self.group):
            total, ev = _loss(self.assets, self.params, self.frozen,
                              self.assemble, self.target_silhouette,
                              self.target_joints2d, self.mask, self.log_vars,
                              self.loss_cfg, self.fit_cfg, it, self.shares)
        self.opt.zero_grad(set_to_none=True)
        with profiling.span("fit.backward"):
            total.backward()
        with profiling.span("fit.select"), torch.no_grad():
            self.select(ev, it == 0)
            if self.snaps is not None:
                self.snaps.append({k: v.detach().clone()
                                   for k, v in self.params.items()})
        with profiling.span("fit.step"):
            self.opt.step()


def graph_engages(device, mesh, fit_cfg: FitConfig) -> bool:
    """Whether :func:`run_fit_loop` replays its iteration as a CUDA graph:
    on CUDA tensors, without a mesh (the sharded fits' collectives stay
    eager), without snapshots, without the silhouette warm-up (its scale
    changes with the iteration), and with at least two iterations (the
    first runs eagerly)."""
    return (torch.device(device).type == "cuda" and mesh is None
            and fit_cfg.snapshot_every is None
            and fit_cfg.silh_warmup_iters == 0 and fit_cfg.iters >= 2)


def _layout(x: torch.Tensor) -> tuple:
    return tuple(x.shape), x.stride(), x.dtype


def plan_key(assets: SMPLAssets, trainable: dict, frozen: dict,
             assemble: Callable, target_silhouette, target_joints2d, mask,
             metric_weights, fit_cfg: FitConfig, group_size: int) -> tuple:
    """What a captured iteration depends on: the device, the layouts of
    every tensor it reads (rows included), ``group_size``, the assembler,
    every ``FitConfig`` field but ``iters``, the assets' tensors (by
    identity: the plan holds them), and the global switches that choose
    its kernels (deterministic algorithms, TF32 matrix products)."""
    tensors = [getattr(assets, f.name) for f in dataclasses.fields(assets)
               if f.name != "parents"]
    switches = (torch.are_deterministic_algorithms_enabled(),
                torch.backends.cuda.matmul.allow_tf32)
    return (target_joints2d.device, group_size, assemble, switches,
            dataclasses.replace(fit_cfg, iters=0),
            tuple((k, _layout(v)) for k, v in trainable.items()),
            tuple((k, _layout(v)) for k, v in frozen.items()),
            tuple(_layout(x) for x in (target_silhouette, target_joints2d,
                                       mask, metric_weights)),
            tuple(id(t) for t in tensors), tuple(assets.parents))


def _buffer(x: torch.Tensor) -> torch.Tensor:
    """A tensor of ``x``'s shape, strides and type, for :meth:`_Loop.load`
    to fill."""
    return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                               device=x.device)


def _capture(fn: Callable):
    """A CUDA graph of what ``fn`` launches (captured, not run) and the
    K1/K2 launches each of its replays makes."""
    graph = torch.cuda.CUDAGraph()
    with band_raster.graph_launches() as launches, torch.cuda.graph(graph):
        fn()
    return graph, launches


class _GraphPlan:
    """A fit loop whose iteration is captured once as a CUDA graph and
    replayed: iteration 0 runs eagerly (it records the initial metrics and
    creates Adam's state), the first call captures iteration 1 on the
    plan's buffers, and every later iteration of every call through the
    plan replays it. Replays add the K1/K2 launches the graph holds to
    ``band_raster.LAUNCHES``."""

    def __init__(self, key: tuple, loop: _Loop):
        self.key, self.loop = key, loop
        self.graph, self.launches = None, {}

    def run(self, iters: int) -> None:
        with profiling.span("fit.iter"):
            self.loop.iterate(0)
        if self.graph is None:
            self.graph, self.launches = _capture(
                lambda: self.loop.iterate(1))
            profiling.count("fit.graph_captures", 1)
        for _ in range(1, iters):
            with profiling.span("fit.iter"), profiling.span("fit.replay"):
                self.graph.replay()
                band_raster.add_launches(self.launches)
        profiling.count("fit.graph_iters", iters - 1)


# The last plan only, so that the graphs' memory stays bounded.
_PLAN: Optional[_GraphPlan] = None


def _replayed_fit(assets, trainable, frozen, assemble, target_silhouette,
                  target_joints2d, mask, metric_weights, fit_cfg,
                  group_size) -> dict:
    """The fit through the plan of these inputs (captured on first use;
    a plan of other inputs is dropped first). Returns a copy of its best
    dict."""
    global _PLAN
    inputs = (target_silhouette, target_joints2d, mask, metric_weights)
    key = plan_key(assets, trainable, frozen, assemble, *inputs, fit_cfg,
                   group_size)
    if _PLAN is None or _PLAN.key != key:
        _PLAN = None
        loop = _Loop(assets, trainable,
                     {k: _buffer(v) for k, v in frozen.items()}, assemble,
                     *(_buffer(x) for x in inputs), fit_cfg, group_size)
        _PLAN = _GraphPlan(key, loop)
    _PLAN.loop.load(trainable, frozen, *inputs)
    _PLAN.run(fit_cfg.iters)
    best = _PLAN.loop.best
    return {k: ({p: t.clone() for p, t in v.items()} if k == "params"
                else v.clone()) for k, v in best.items()}


def run_fit_loop(assets: SMPLAssets,
                 trainable: dict,
                 frozen: dict,
                 assemble: Callable,
                 target_silhouette: torch.Tensor,
                 target_joints2d: torch.Tensor,
                 fit_cfg: FitConfig,
                 mask: Optional[torch.Tensor] = None,
                 group_size: int = 1,
                 metric_weights: Optional[torch.Tensor] = None,
                 mesh=None):
    """Generic fitting loop on the device of its inputs.

    Args:
      trainable: {name: tensor} optimised (leading axis = player groups).
      frozen: {name: tensor} constants the assembler reads.
      assemble: fn(params, frozen) → (body_pose, global_orient, betas,
        cam_wp) over the flat row batch.
      mask: (rows,) 1.0 for real rows; padded rows contribute no loss.
      group_size: rows per player; metrics and best-iterate selection are
        reduced per group.
      metric_weights: (rows,) weights of the per-group metric mean.
      mesh: a ``parallel.mesh.Mesh``: every rank passes the global batch
        and fits its slice over the data axis (see the module docstring).
        Rows must be a multiple of the data axis, and so must the groups
        where ``group_size > 1``; pad with ``mask``.

    Where :func:`graph_engages`, the iterations after the first replay one
    CUDA graph, captured once per plan (:class:`_GraphPlan`) and reused by
    later calls with the same :func:`plan_key`. It runs the eager loop's
    kernels in the eager loop's order, so under deterministic algorithms
    the two agree bit for bit (without them the atomic adds of the
    backward's scatters make any two runs differ at rounding level). Each
    call counts its replayed iterations in the counter ``fit.graph_iters``
    (0 in the eager loop), each capture in ``fit.graph_captures``.

    Returns:
      (best params dict, dict of best metrics with (groups,) shapes), for
      every row on every rank.
    """
    dev = target_joints2d.device
    rows = target_joints2d.shape[0]
    groups = rows // group_size
    if mask is None:
        mask = torch.ones((rows,), device=dev)
    if metric_weights is None:
        metric_weights = torch.ones((rows,), device=dev)
    if graph_engages(dev, mesh, fit_cfg):
        best = _replayed_fit(assets, trainable, frozen, assemble,
                             target_silhouette, target_joints2d, mask,
                             metric_weights, fit_cfg, group_size)
        return best["params"], best
    shares, group = _Shares(), None
    if mesh is not None:
        trainable, frozen, tensors, target_joints2d, shares = _shard_fit(
            mesh, rows, groups, group_size, fit_cfg, trainable, frozen,
            [mask, metric_weights, target_silhouette], target_joints2d)
        mask, metric_weights, target_silhouette = tensors
        group = mesh.data_group

    loop = _Loop(assets, trainable, frozen, assemble, target_silhouette,
                 target_joints2d, mask, metric_weights, fit_cfg, group_size,
                 shares, group)
    for it in range(fit_cfg.iters):
        with profiling.span("fit.iter"):
            loop.iterate(it)
    profiling.count("fit.graph_iters", 0)
    best = loop.best
    if loop.snaps is not None:
        best["snapshots"] = {
            k: torch.stack([s[k] for s in loop.snaps])[::fit_cfg.snapshot_every]
            for k in loop.params}
    if mesh is not None:
        best = _gather_best(best, group)
    return best["params"], best


def _gather_best(best: dict, group) -> dict:
    """Every rank's groups of the best dict, in one all-gather."""
    flat = {(k, None): v for k, v in best.items() if not isinstance(v, dict)}
    for part in ("params", "snapshots"):
        flat.update({(part, k): v for k, v in best.get(part, {}).items()})
    got = gather_dict_rows(flat, group,
                           {k: 1 for k in flat if k[0] == "snapshots"})
    out = {}
    for (part, k), v in got.items():
        if k is None:
            out[part] = v
        else:
            out.setdefault(part, {})[k] = v
    return out


def fit_metrics(assets: SMPLAssets, init: FitInit, silhouette, joints2d,
                fit_cfg: FitConfig):
    """Metrics of one parameter set: silhouette IoU and int-cast joint px
    error."""
    with torch.no_grad():
        ev = evaluate_fit(assets, init.body_pose, init.global_orient,
                          init.betas, init.cam_wp, silhouette, joints2d,
                          fit_cfg)
    return {"silh_iou": ev["iou"], "joint_err": ev["joint_err"]}
