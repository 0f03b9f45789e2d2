"""System under test: the regressor-initialised single-view fit.

Each call takes the next batch of the traffic pool through the package's
``pipeline/predict.py:predict_smpl`` (the committed regressor) and
``fit/single_view.py:single_view_fit`` at the configuration's fit
settings, and copies the results to the host, which waits for the card.
The last answers of every pool batch are kept for the check, with the
initial estimates the regressor gave them.
"""

from __future__ import annotations

import dataclasses
import importlib
import time

import numpy as np
import torch

from benchmark import counts
from benchmark.checks import svfit as check_svfit
from benchmark.harness import REPO
from benchmark.reference import smpl

RESULT_FIELDS = ("body_pose", "global_orient", "betas", "cam_wp",
                 "silh_iou", "init_silh_iou", "best_iter")


class System:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from soccerplayershapepose_torch.convert import (
            load_regressor_weights)
        from soccerplayershapepose_torch.fit.engine import FitConfig
        from soccerplayershapepose_torch.smpl.assets import (
            synthesize_assets)
        self.config, self.seed, self.device = config, seed, device
        fit = config["fit"]
        t0 = time.perf_counter()
        self.regressor = load_regressor_weights(
            str(REPO / config["weights"]["regressor"]), device=device)
        self.assets = synthesize_assets(device=device)
        t1 = time.perf_counter()
        self.fit_cfg = FitConfig(iters=fit["iters"], lr=fit["lr"],
                                 proxy_wh=fit["wh"], render_wh=fit["wh"],
                                 sigma=fit["sigma"],
                                 backface_cull=fit["backface_cull"])
        self.warm_cfg = dataclasses.replace(self.fit_cfg,
                                            iters=config["warm_iters"])
        generator = importlib.import_module(
            f"benchmark.traffic.{traffic['generator']}")
        self.pool = generator.make({**traffic, "wh": fit["wh"]}, seed, device)
        self.setup_phases = {"weights": t1 - t0,
                             "traffic": time.perf_counter() - t1}
        self.batch = self.pool["batch"]
        self.n_batches = self.pool["silhouette"].shape[0] // self.batch
        self.next = 0
        self.kept = {}
        self.spans = None

    def _run(self, index: int, fit_cfg):
        from soccerplayershapepose_torch.fit.engine import FitInit
        from soccerplayershapepose_torch.fit.single_view import (
            single_view_fit)
        from soccerplayershapepose_torch.pipeline.predict import (
            predict_smpl)
        sl = slice(index * self.batch, (index + 1) * self.batch)
        sil = self.pool["silhouette"][sl]
        j2d = self.pool["joints2d"][sl]
        t0 = time.perf_counter()
        pred = predict_smpl(self.regressor, self.assets, sil, j2d,
                            proxy_wh=fit_cfg.proxy_wh, device=self.device)
        t0 = self._lap("predict", t0)
        init = FitInit(body_pose=pred.pose_rotmats[:, 1:],
                       global_orient=pred.pose_rotmats[:, :1],
                       betas=pred.betas, cam_wp=pred.cam_wp)
        res = single_view_fit(self.assets, init, sil, j2d, fit_cfg,
                              device=self.device)
        self._lap("fit", t0)
        host = {k: getattr(res, k).cpu() for k in RESULT_FIELDS}
        return pred, host

    def _lap(self, name: str, t0: float) -> float:
        if self.spans is None:
            return t0
        if self.device == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.spans.setdefault(name, []).append(now - t0)
        return now

    def warm(self) -> None:
        self.spans = {}
        self._run(0, self.warm_cfg)
        self.setup_phases.update(
            {f"warm_{k}": v[0] for k, v in self.spans.items()})
        self.spans = None

    def call(self) -> int:
        index = self.next
        self.next = (self.next + 1) % self.n_batches
        pred, host = self._run(index, self.fit_cfg)
        self.kept[index] = {
            "rotmats": pred.pose_rotmats, "betas0": pred.betas,
            "cam0": pred.cam_wp, **host}
        return self.batch

    def traced_calls(self) -> int:
        self.call()
        return 1

    def work(self) -> dict:
        """What one iteration of the last batch computes: the support
        pairs of its initial and best meshes (averaged), SMPL's forward
        and backward, the rasterizers' bytes."""
        fit = self.config["fit"]
        wh, sigma = fit["wh"], fit["sigma"]
        kept = self.kept[(self.next - 1) % self.n_batches]
        model = smpl.load(self.device)
        dev = self.device
        with torch.no_grad():
            counted = []
            for rot, betas, cam in (
                    (kept["rotmats"], kept["betas0"], kept["cam0"]),
                    (torch.cat([kept["global_orient"], kept["body_pose"]],
                               1).to(dev), kept["betas"].to(dev),
                     kept["cam_wp"].to(dev))):
                verts, _ = smpl.forward(model, betas, rot[:, 1:], rot[:, :1])
                v2d = smpl.project(verts, smpl.translation(cam, wh), wh)
                counted.append(counts.support_pairs(v2d, model.faces, wh,
                                                    sigma))
        pairs_ = float(np.mean(counted))
        rows = self.batch
        return {"rows": rows, "iters": fit["iters"],
                "sil_pairs": pairs_,
                "k1_bytes": counts.silhouette_bytes(rows, wh, False),
                "k2_bytes": counts.silhouette_bytes(rows, wh, True),
                "smpl_flops": 3.0 * counts.smpl_forward_flops(rows)}

    def check(self, control: bool = False):
        kept = self.kept
        targets = self.pool
        del self.regressor, self.assets
        self.pool = None
        if self.device == "cuda":
            torch.cuda.empty_cache()
        return check_svfit.run(self.config, kept, targets, self.batch,
                               self.seed, self.device, control)
