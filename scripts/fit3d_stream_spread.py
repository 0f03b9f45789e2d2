#!/usr/bin/env python3
"""Spread of the GT-3D benchmarks' init MPJPE-PA between batches and
between random streams, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/fit3d_stream_spread.py [--batches 24]

For ``evaluate_fit_3d``'s held-out batches (8 corrupted 512^2 crops with
occluders each, the committed 18-channel regressor) it prints the
regressor's init MPJPE-PA per batch for the JAX package's key stream
(seed 20,000,000, batch i from ``fold_in(PRNGKey(seed), i)``: the draws
replayed as tests/test_torch_synth_eval.py and tests/test_torch_fit3d.py
replay them) and for the port's own stream (a torch generator with the
same seed), each batch rendered by the port through K3's PyTorch mirror.
Its first two JAX batches are the record's
(``weights/fit3d_benchmark_r04d.json``, init 143.2 mm). No fit runs: the
init alone shows how far two streams' means lie apart at a given number
of batches. Imports both packages; the port itself imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=24)
    ap.add_argument("--seed", type=int, default=20_000_000)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()

    import jax
    import numpy as np
    import torch

    from soccerplayershapepose_torch import convert
    from soccerplayershapepose_torch.smpl import synthesize_assets
    from soccerplayershapepose_torch.train import straps, synth
    from test_torch_extract import fast_rasterize_attributes
    from test_torch_fit3d import jax_corruption_draws
    from test_torch_synth_eval import jax_crop_draws

    torch.set_num_threads(args.threads)
    synth.rasterize_attributes = fast_rasterize_attributes
    assets = synthesize_assets()
    model = convert.load_regressor_weights(
        os.path.join(ROOT, "weights", "regressor_18ch_f16.npz"), "cpu")
    b, wh = 8, 512

    def init_mpjpe_pa(draws):
        batch = straps.synth_fit_batch(assets, draws, wh=wh)
        cam, rot, betas = straps.infer_rotmats(model, assets, batch["proxy"])
        return straps.metrics_float(
            assets, cam, rot, betas, batch["target_pose"],
            batch["target_betas"], batch["joints2d"])["mpjpe_pa_mm"]

    jax_stream = []
    for i in range(args.batches):
        rng = jax.random.fold_in(jax.random.PRNGKey(args.seed), i)
        k_synth, k_corrupt = jax.random.split(rng)
        jax_stream.append(init_mpjpe_pa(straps.RegressorDraws(
            jax_crop_draws(k_synth, b),
            jax_corruption_draws(k_corrupt, b, wh, 0.0))))
    gen = torch.Generator().manual_seed(args.seed)
    port_stream = [init_mpjpe_pa(straps.sample_fit_draws(gen, b, wh))
                   for _ in range(args.batches)]
    for name, vals in (("jax_stream", jax_stream),
                       ("port_stream", port_stream)):
        v = np.asarray(vals)
        print(json.dumps({
            "stream": name, "seed": args.seed, "batch": b, "wh": wh,
            "init_mpjpe_pa_mm_per_batch": [round(x, 2) for x in vals],
            "mean_first_2": float(v[:2].mean()),
            "mean_first_8": float(v[:8].mean()),
            "mean_all": float(v.mean()), "std_per_batch": float(v.std())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
