"""System under test: the broadcast frame pipeline.

Each call hands the next frame batch of the traffic pool (host numpy
arrays, as a decoder yields them) to the function that the package's
``pipeline/fullframe.py:build_frame_pipeline`` returns, and waits for its
outputs on the card: a call's latency runs from the hand-over, copy to
the card included, to that wait's end. The last answers for every pool
frame are kept for the check. With spans on, the pipeline is built with
``stage_times`` and synchronises after each stage.
"""

from __future__ import annotations

import importlib
import time

import torch

from benchmark import counts
from benchmark.checks import frame as check_frame
from benchmark.harness import REPO
from benchmark.reference import nets

OUTPUT_FIELDS = ("boxes", "scores", "joints2d", "vertices", "pose_rotmats",
                 "betas", "cam_wp")


class System:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from soccerplayershapepose_torch.convert import (
            load_detector_weights, load_proxynet_weights,
            load_regressor_weights)
        from soccerplayershapepose_torch.smpl.assets import (
            synthesize_assets)
        self.config, self.seed, self.device = config, seed, device
        t0 = time.perf_counter()
        wts = {k: str(REPO / v) for k, v in config["weights"].items()}
        self.nets = (load_detector_weights(wts["detector"], device=device),
                     load_proxynet_weights(wts["proxynet"], device=device,
                                           with_iuv=False),
                     load_regressor_weights(wts["regressor"], device=device))
        self.assets = synthesize_assets(device=device)
        t1 = time.perf_counter()
        generator = importlib.import_module(
            f"benchmark.traffic.{traffic['generator']}")
        self.pool = generator.make(
            {**traffic, "height": config["frame"]["height"],
             "width": config["frame"]["width"]}, seed, device)
        self.setup_phases = {"weights": t1 - t0,
                             "traffic": time.perf_counter() - t1}
        self.per_call = self.pool["per_call"]
        self.n_batches = self.pool["frames"].shape[0] // self.per_call
        self.fn = self._build(None)
        self.stage_fn = None
        self.next = 0
        self.kept = {}
        self.spans = None
        self.stage_times = {}

    def _build(self, stage_times):
        from soccerplayershapepose_torch.pipeline.fullframe import (
            build_frame_pipeline)
        fr = self.config["frame"]
        return build_frame_pipeline(*self.nets, max_players=fr["top_k"],
                                    crop_wh=fr["crop"],
                                    border=fr["border"], device=self.device,
                                    stage_times=stage_times)

    def _frames(self, index: int):
        return self.pool["frames"][index * self.per_call:
                                   (index + 1) * self.per_call]

    def warm(self) -> None:
        for _ in range(self.config["warm_calls"]):
            self.fn(self.assets, self._frames(0))
        self.stage_fn = self._build(self.stage_times)
        self.stage_fn(self.assets, self._frames(0))
        self.stage_times.clear()

    def call(self) -> int:
        index = self.next
        self.next = (self.next + 1) % self.n_batches
        fn = self.fn if self.spans is None else self.stage_fn
        self.stage_times.clear()
        out = fn(self.assets, self._frames(index))
        if self.device == "cuda":
            torch.cuda.synchronize()
        if self.spans is not None:
            for k, v in self.stage_times.items():
                self.spans.setdefault(k, []).append(v)
        self.kept[index] = {k: getattr(out, k) for k in OUTPUT_FIELDS}
        return self.per_call

    def traced_calls(self) -> int:
        for _ in range(self.config["traced_calls"]):
            self.call()
        return self.config["traced_calls"]

    def work(self) -> dict:
        """Operations of one call: the detector over the frames, ProxyNet
        on the top-K crops, the regressor on their proxies, SMPL."""
        fr = self.config["frame"]
        k = fr["top_k"] * self.per_call
        wts = {n: nets.load_flat(str(REPO / self.config["weights"][n]),
                                 "cpu")
               for n in ("detector", "proxynet", "regressor")}
        flops = nets.count_flops(nets.detector, wts["detector"],
                                 (self.per_call, 3, fr["height"],
                                  fr["width"]))
        flops += nets.count_flops(nets.proxynet, wts["proxynet"],
                                  (k, 3, fr["crop"], fr["crop"]))
        flops += nets.count_flops(nets.regressor, wts["regressor"],
                                  (k, 18, 256, 256),
                                  (157,))
        return {"call_flops": flops + counts.smpl_forward_flops(k),
                "frames_per_call": self.per_call}

    def check(self, control: bool = False):
        kept, frames = self.kept, self.pool["frames"]
        del self.nets, self.fn, self.stage_fn, self.assets
        if self.device == "cuda":
            torch.cuda.empty_cache()
        return check_frame.run(self.config, kept, frames, self.per_call,
                               self.seed, self.device, control)
