"""The single-view fit's answers against the plain reference.

A sample of the window's answers, drawn from the seed: one row from each
of ``rows`` equal strata of a batch, each from a batch the window ran.
The reference recomputes each sampled row from the same target
silhouette and keypoints: the regressor's initial estimate, then the whole
fit, recording every iterate (rows are independent given the batch size,
which the joints term's mean takes).

A fit's 100 Adam steps carry a rounding-level difference in a gradient to
pixel-level differences in the kept mesh (Adam moves a parameter by ~lr
whatever its gradient's size), so the kept mesh cannot be held to the
reference's: the control, 300 times farther off at the start, ends as
far off as a sound run. The numbers compared are the start, the kept
iterate's own evaluation, and the progress the steps made:

* ``init_px``: the widest gap, in pixels of a ``px_wh``² crop, between a
  vertex of the program's initial mesh and of the reference's (the fit's
  own camera);
* ``kept_iou_gap``: the widest gap between the silhouette IoU the program
  reports for its kept iterate and the reference's IoU of that iterate's
  parameters;
* ``progress_gap``: over the sampled rows, Σ|g − g_ref| / Σ|g_ref|, where
  g is the share by which the program's kept iterate lowered the row's
  loss from the program's start and g_ref the share by which the
  reference's iterate of the same number lowered it from the reference's
  start (both evaluated by the reference); a fit whose steps leave its
  state unchanged reads 1.

Each has its limit in the configuration's file; the other numbers
:func:`numbers` returns are printed by the calibration only.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import REPO
from benchmark.reference import fit as ref_fit
from benchmark.reference import nets, precision, predict, smpl


def sample(seed: int, kept: dict, batch: int, rows: int):
    """[(pool batch, row)], one row per stratum of ``batch // rows``."""
    rng = np.random.default_rng(seed)
    batches = sorted(kept)
    step = batch // rows
    return [(batches[rng.integers(len(batches))],
             j * step + int(rng.integers(step))) for j in range(rows)]


def reference(config: dict, sil, j2d, batch: int, device,
              tf32: bool = False) -> dict:
    """The reference's answers for target rows: its initial estimate and
    its whole trajectory; with ``tf32`` in the control's precision."""
    fit = config["fit"]
    w = nets.load_flat(str(REPO / config["weights"]["regressor"]), device)
    model = smpl.load(device)
    with (precision.tf32() if tf32 else precision.fp32()):
        p = predict.predict(w, model, sil, j2d, fit["wh"])
        traj = ref_fit.fit(model, p.rotmats[:, 1:], p.rotmats[:, :1],
                           p.betas, p.cam_wp, sil, j2d, batch, fit["iters"],
                           fit["lr"], fit["sigma"], fit["wh"])
    return {"rotmats": p.rotmats, "betas0": p.betas, "cam0": p.cam_wp,
            "traj": traj}


def as_program(ref: dict) -> dict:
    """A reference run's answers in the program's form (the control put
    in the program's place)."""
    t = ref["traj"]
    rows = torch.arange(t.best_iter.shape[0], device=t.best_iter.device)
    pick = t.best_iter - 1
    return {"rotmats": ref["rotmats"], "betas0": ref["betas0"],
            "cam0": ref["cam0"], "body_pose": t.body_pose[pick, rows],
            "global_orient": t.orient[pick, rows],
            "betas": t.betas[pick, rows], "cam_wp": t.cam_wp[pick, rows],
            "silh_iou": t.iou[pick, rows], "init_silh_iou": t.iou[0],
            "best_iter": t.best_iter}


def _pixels(model, rot, betas, cam, wh):
    verts, _ = smpl.forward(model, betas, rot[:, 1:], rot[:, :1])
    return smpl.project(verts, smpl.translation(cam, wh), wh)


@torch.no_grad()
def numbers(prog: dict, ref: dict, config: dict, device, sil, j2d,
            batch: int) -> dict:
    fit = config["fit"]
    wh = config["check"]["px_wh"]
    model = smpl.load(device)
    t = ref["traj"]
    rows = torch.arange(t.best_iter.shape[0], device=device)
    it = prog["best_iter"].to(device).long() - 1
    kept = torch.cat([prog["global_orient"], prog["body_pose"]], 1)
    with precision.fp32():
        a = _pixels(model, prog["rotmats"], prog["betas0"], prog["cam0"],
                    wh)
        b = _pixels(model, ref["rotmats"], ref["betas0"], ref["cam0"], wh)
        init_px = torch.linalg.vector_norm(a - b, dim=-1).max()
        a = _pixels(model, kept, prog["betas"], prog["cam_wp"], wh)
        b = _pixels(model, torch.cat([t.orient[it, rows],
                                      t.body_pose[it, rows]], 1),
                    t.betas[it, rows], t.cam_wp[it, rows], wh)
        row_px = torch.linalg.vector_norm(a - b, dim=-1).amax(-1)
        args = (sil, j2d, batch, fit["sigma"], fit["wh"])
        at_kept = ref_fit.evaluate(model, kept, prog["betas"],
                                   prog["cam_wp"], *args)
        at_init = ref_fit.evaluate(model, prog["rotmats"], prog["betas0"],
                                   prog["cam0"], *args)
    gain_prog = (at_init["loss"] - at_kept["loss"]) / at_init["loss"]
    gain_ref = (t.loss[0] - t.loss[it, rows]) / t.loss[0]
    return {
        "init_px": float(init_px),
        "kept_iou_gap": float(torch.abs(prog["silh_iou"]
                                        - at_kept["iou"]).max()),
        "progress_gap": float(torch.abs(gain_prog - gain_ref).sum()
                              / torch.clamp(torch.abs(gain_ref).sum(),
                                            min=1e-12)),
        "fit_px": float(row_px.max()),
        "fit_px_median": float(row_px.median()),
        "init_iou_gap": float(torch.abs(prog["init_silh_iou"]
                                        - t.iou[0]).max()),
        "best_iter_flips": float((prog["best_iter"].to(device)
                                  != t.best_iter).float().mean()),
        "rows_fit_px": row_px.tolist(),
        "rows_gain": gain_prog.tolist(), "rows_ref_gain": gain_ref.tolist(),
        "rows_best_iter": prog["best_iter"].tolist(),
        "rows_ref_best_iter": t.best_iter.tolist()}


def limited(got: dict, config: dict) -> dict:
    """The numbers that have a limit, each beside it."""
    limits = config["check"]["limits"]
    return {k: {"value": got[k], "limit": v} for k, v in limits.items()}


def gather(kept: dict, targets: dict, picks, batch: int, device):
    """The program's answers and the targets of the sampled rows."""
    prog = {k: torch.stack([kept[b][k][r] for b, r in picks]).to(device)
            for k in kept[picks[0][0]]}
    idx = torch.tensor([b * batch + r for b, r in picks], device=device)
    return prog, targets["silhouette"][idx], targets["joints2d"][idx]


def run(config: dict, kept: dict, targets: dict, batch: int, seed: int,
        device, control: bool = False) -> dict:
    """The numbers of the program's sampled answers; with ``control`` a
    second dict: those of the control (the reference in TF32 put in the
    program's place) on the same rows."""
    picks = sample(seed, kept, batch, config["check"]["rows"])
    prog, sil, j2d = gather(kept, targets, picks, batch, device)
    ref = reference(config, sil, j2d, batch, device)
    got = numbers(prog, ref, config, device, sil, j2d, batch)
    if not control:
        return limited(got, config)
    ctl = as_program(reference(config, sil, j2d, batch, device, tf32=True))
    return got, numbers(ctl, ref, config, device, sil, j2d, batch)
