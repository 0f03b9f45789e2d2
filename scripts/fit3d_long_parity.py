#!/usr/bin/env python3
"""The single-view GT-3D benchmark over a full-length fit, the port
against the JAX package on the CPU, from the same draws.

    JAX_PLATFORMS=cpu python3 scripts/fit3d_long_parity.py \\
        [--iters 100] [--render 32] [--batch 8] [--threads 8]

One batch of ``evaluate_fit_3d`` (seed 20,000,000, batch 0 of the JAX key
stream: the first batch of ``weights/fit3d_benchmark_r04d.json``) at 512^2
with the committed regressor and the record's fit knobs, the fit rendered
at ``--render``^2 (the record renders at 256^2; the port's dense CPU
silhouette costs ~1.8 s a row-iteration at 32^2 on one core). The JAX
package renders its crops with its dense oracle, the port through K3's
PyTorch mirror. Prints both packages' metrics and the relative gap of
each: the tests hold 2 iterations to 1e-3, this shows how far the two
fits' metrics drift apart over the stage's 100. Imports both packages;
the port itself imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--render", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()

    import jax
    import numpy as np
    import torch

    from soccerplayershapepose_tpu.fit.engine import FitConfig as JFitConfig
    from soccerplayershapepose_tpu.models import regressor as jreg
    from soccerplayershapepose_tpu.smpl import assets as jassets
    from soccerplayershapepose_tpu.train import straps as jstraps
    from soccerplayershapepose_torch import convert
    from soccerplayershapepose_torch.fit import FitConfig
    from soccerplayershapepose_torch.smpl import synthesize_assets
    from soccerplayershapepose_torch.train import straps, synth
    from test_torch_extract import fast_rasterize_attributes
    from test_torch_fit3d import jax_corruption_draws
    from test_torch_synth_eval import _nest, jax_crop_draws

    torch.set_num_threads(args.threads)
    synth.rasterize_attributes = fast_rasterize_attributes
    weights = os.path.join(ROOT, "weights", "regressor_18ch_f16.npz")
    seed, wh, b = 20_000_000, 512, args.batch
    knobs = dict(iters=args.iters, proxy_wh=wh, render_wh=args.render,
                 lr=1e-3, joint_conf_weighting=True, betas_prior=0.01,
                 pose_prior=0.0, rot_ortho_prior=0.05, silh_warmup_iters=0,
                 joints2d_scale=1e6, faces_per_chunk=86)

    t0 = time.time()
    with np.load(weights) as z:
        variables = _nest({k: z[k] for k in z.files})
    want = jstraps.evaluate_fit_3d(
        jreg.SingleInputRegressor(in_channels=18, resnet_layers=18),
        variables["params"], variables["batch_stats"],
        jassets.synthesize_assets(), n_batches=1, batch=b, wh=wh,
        fit_cfg=JFitConfig(use_pallas=False, **knobs), seed=seed)
    t_jax = time.time() - t0

    rng = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    k_synth, k_corrupt = jax.random.split(rng)
    t0 = time.time()
    got = straps.evaluate_fit_3d(
        convert.load_regressor_weights(weights, "cpu"), synthesize_assets(),
        wh=wh, fit_cfg=FitConfig(**knobs), device="cpu",
        draws=[straps.RegressorDraws(
            jax_crop_draws(k_synth, b),
            jax_corruption_draws(k_corrupt, b, wh, 0.0))])
    t_port = time.time() - t0
    gaps = {k: (got[k] - want[k]) / abs(want[k]) for k in want
            if isinstance(want[k], float)}
    print(json.dumps({"iters": args.iters, "render_wh": args.render,
                      "batch": b, "jax": want, "port": got,
                      "relative_gap": gaps,
                      "max_abs_relative_gap": max(abs(v)
                                                  for v in gaps.values()),
                      "cpu_s": {"jax": round(t_jax, 1),
                                "port": round(t_port, 1)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
