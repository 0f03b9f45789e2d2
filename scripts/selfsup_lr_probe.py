"""Self-supervised fine-tuning rates on one batch, on the card.

Writes the first scene of ``chip_smoke.py``'s mint tree (the scene factory
at seed 60,000,000: 6 players, 3 views at 512²), takes its first 8 views
as one batch, and runs 10 steps of ``train/selfsup.py`` from the committed
regressor for items ``both``, ``shape`` and ``pose`` at Adam rates 1e-4,
3e-5, 1e-5, 3e-6 and 1e-6, printing one JSON line per run: the joints-2D
error, the silhouette IoU and the loss after each step. It is how
``chip_smoke.py`` ``selfsup_train`` chose its rate (~1 min on an H100):

    python3 scripts/selfsup_lr_probe.py
"""

import json
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import numpy as np
    import torch
    from soccerplayershapepose_torch.convert import load_regressor_weights
    from soccerplayershapepose_torch.drivers import stages
    from soccerplayershapepose_torch.pipeline.proxy import (
        create_proxy_representation)
    from soccerplayershapepose_torch.smpl import synthesize_assets
    from soccerplayershapepose_torch.train import scenes, selfsup
    dev = torch.device("cuda")
    assets = synthesize_assets(device=dev)
    weights = os.path.join(REPO, "weights", "regressor_18ch_f16.npz")
    tree = tempfile.mkdtemp(prefix="_smoke_lr_", dir=REPO)
    try:
        draws = scenes.sample_scene_views_draws(
            torch.Generator().manual_seed(60_000_000), 6, 3)
        data = scenes.synth_scene_views(assets, draws, wh=512)
        scenes.write_scene_tree(tree, "game0", "scene0", data,
                                corruption=scenes.sample_tree_corruption(
                                    torch.Generator().manual_seed(
                                        60_000_001), data),
                                write_images=False)
        sils, j2ds = [], []
        for node, view in stages._gather_views(
                os.path.join(tree, "images"), os.path.join(tree, "proxies"),
                True)[:8]:
            s, j = stages.load_proxy_batch(os.path.join(
                tree, "proxies", node.game, node.scene, node.player), [view])
            sils.append(s[0])
            j2ds.append(j[0])
    finally:
        shutil.rmtree(tree, ignore_errors=True)
    sil = torch.from_numpy(np.stack(sils)).to(dev)
    j2d = torch.from_numpy(np.stack(j2ds)).to(dev)
    batch = {"proxy": create_proxy_representation(sil, j2d),
             "silhouette": sil, "joints2d": j2d[..., :2]}
    for item in ("both", "shape", "pose"):
        for lr in (1e-4, 3e-5, 1e-5, 3e-6, 1e-6):
            st = selfsup.make_selfsup_state(
                load_regressor_weights(weights, dev), item, lr)
            step = selfsup.make_selfsup_step(item, render_wh=512, sigma=1e-4)
            curve = []
            for _ in range(10):
                _, m, _ = step(st, assets, batch)
                curve.append([float(m["joints2D_l2e"]),
                              float(m["silh_iou"]), float(m["loss"])])
            print(json.dumps({"item": item, "lr": lr, "curve": curve}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
