#!/usr/bin/env python3
"""Spread of the relation evaluation's metrics between batches and between
random streams, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/relation_stream_spread.py [--batches 64]

For ``evaluate_relation``'s held-out batches (8 scenes of 6 players,
per-scene noise σ ~ U[0.05, 0.35)) it evaluates the committed v0 and v1
relation modules (``weights/relation_v{0,1}.npz``) with the port, on the
CPU, batch by batch, for two streams: the JAX package's key stream (seed
50,000,000, batch i from ``fold_in(PRNGKey(seed), i)``, the draws
replayed as tests/test_torch_relation.py replays them; the port matches
the JAX package on identical draws within 1e-6 relative) and the port's
own stream (a torch generator with the same seed). It prints, per stream
and variant, the mean and the standard deviation over batches of each
metric for the first 8 batches (the committed records' and
``chip_smoke.py``'s count) and for all ``--batches``, as one JSON line.
Imports both packages; the port itself imports no JAX.
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
    ap.add_argument("--batches", type=int, default=64)
    ap.add_argument("--seed", type=int, default=50_000_000)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()

    import jax
    import numpy as np
    import torch

    from soccerplayershapepose_torch import convert
    from soccerplayershapepose_torch.smpl import synthesize_assets
    from soccerplayershapepose_torch.train import relation
    from test_torch_relation import jax_relation_draws

    torch.set_num_threads(args.threads)
    assets = synthesize_assets()
    b, n = 8, 6
    gen = torch.Generator().manual_seed(args.seed)
    streams = {
        "jax": [jax_relation_draws(jax.random.fold_in(
            jax.random.PRNGKey(args.seed), i), b, n)
            for i in range(args.batches)],
        "port": [relation.sample_relation_draws(gen, b, n)
                 for _ in range(args.batches)]}
    out = {"batches": args.batches, "seed": args.seed, "scenes": b,
           "players": n}
    for v in (0, 1):
        model = convert.load_relation_weights(
            os.path.join(ROOT, "weights", "relation_v%d.npz" % v), "cpu")
        for name, draws in streams.items():
            rows = [relation.evaluate_relation(model, assets, draws=[d],
                                               device="cpu")
                    for d in draws]
            keys = [k for k in rows[0] if k != "n_scenes"]
            for label, part in (("first8", rows[:8]), ("all", rows)):
                arr = {k: np.array([r[k] for r in part]) for k in keys}
                out["v%d_%s_%s" % (v, name, label)] = {
                    k: [float(a.mean()), float(a.std(ddof=1))]
                    for k, a in arr.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
