"""Player-view traffic: target silhouettes and keypoints of random bodies.

A pool of ``pool`` views, each the {0, 1} silhouette (``wh``²) of a random
body's front faces under the fit's own camera (focal 5000, principal
point at the centre, the translation from a weak-perspective camera whose
scale is drawn from ``cam_scale``: the size a player has in a crop grown
by a 40 px border) and its 17 keypoints (the orthographic projection)
with Gaussian pixel noise. The window takes the pool in batches of
``batch`` in order and starts over. Parameters come from the traffic mix's
file; everything random comes from the seed.
"""

from __future__ import annotations

import torch

from benchmark.reference import smpl
from benchmark.traffic import bodies


def make(params: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n, wh, blk = params["pool"], params["wh"], params["render_block"]
    if n % params["batch"]:
        raise ValueError("the pool must hold whole batches")
    model = smpl.load(device)
    body, orient, betas = bodies.random_bodies(
        gen, n, tuple(params["pose_energy"]), params["betas_scale"])
    lo, hi = params["cam_scale"]
    t = params["cam_shift"]
    cam = torch.stack([bodies.uniform(gen, (n,), lo, hi),
                       bodies.uniform(gen, (n,), -t, t),
                       bodies.uniform(gen, (n,), -t, t)], -1)
    noise = bodies.normal(gen, (n, 17, 2)) * params["keypoint_noise_px"]
    sil, j2d = [], []
    with torch.no_grad():
        for s in range(0, n, blk):
            sl = slice(s, s + blk)
            verts, joints = smpl.forward(model, betas[sl], body[sl],
                                         orient[sl])
            v2d = smpl.project(verts, smpl.translation(cam[sl], wh), wh)
            sil.append(bodies.silhouettes(v2d, model.faces, wh))
            j2d.append(smpl.keypoints(joints, cam[sl], wh) + noise[sl])
    return {"silhouette": torch.cat(sil), "joints2d": torch.cat(j2d),
            "batch": params["batch"]}
