#!/usr/bin/env python3
"""Spread of the frame classifier's held-out metrics over seeds, and the
two packages' heads on the same features.

    python3 scripts/classifier_seed_spread.py card --out DIR [--seeds 3 4 5]
    JAX_PLATFORMS=cpu python3 scripts/classifier_seed_spread.py cpu --out DIR

``card`` (on the CUDA card) runs the setting of
``weights/frame_classifier_eval.json`` for each seed, as
``scripts/train_classifier_torch.py`` does: 384 training frames and 96
held-out frames (seed + 1,000,003) from the port's synthesis, the
committed feature net (``weights/frame_classifier.npz``), 10 epochs of
``train_classifier`` at lr 2e-4; the held-out frames go through the
gate's feature path (the preprocessed frame re-quantised to uint8). It
prints each seed's accuracy, main-camera recall and other-shot rejection
and saves the features and labels to ``DIR/features_seed<k>.npz``.

``cpu`` (here, with the JAX package) trains the JAX package's head
(``pipeline/classification.py:train_classifier``) and the port's on the
CPU on those same features, seed for seed (the port's from its own
initial draws and from JAX's initial head), and prints the heads'
metrics: a gap between the packages from one initial head would be the
port's; a spread over seeds and initial heads is the yardstick's.
Imports both packages; the port imports no JAX.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

EPOCHS, LR = 10, 2e-4


def metrics(pred_main, labels):
    import numpy as np
    pred_main = np.asarray(pred_main, bool)
    return {"accuracy": float((pred_main == (labels == 1)).mean()),
            "main_camera_recall": float(pred_main[labels == 1].mean()),
            "other_shot_rejection": float(1.0 - pred_main[labels == 0].mean())}


def card(args):
    import numpy as np
    import torch
    import train_classifier_torch as script
    from soccerplayershapepose_torch.convert import load_classifier_weights
    from soccerplayershapepose_torch.pipeline.classification import (
        make_frame_classifier, train_classifier)
    from soccerplayershapepose_torch.smpl import load_assets
    from soccerplayershapepose_torch.utils.precision import default_device

    dev = default_device(args.device)
    assets = load_assets(device=dev)
    _, features = load_classifier_weights(
        os.path.join(ROOT, "weights", "frame_classifier.npz"), dev)
    os.makedirs(args.out, exist_ok=True)
    for seed in args.seeds:
        images, labels = script.build_dataset(assets, 384, seed, 8, dev)
        feats = script.featurize(features, images, dev)
        ev_images, ev_labels = script.build_dataset(
            assets, 96, seed + 1_000_003, 8, dev)
        gate = make_frame_classifier(torch.nn.Identity(), features, dev)
        ev_feats = np.stack([gate.feature_fn((img * 255).astype(np.uint8))
                             for img in ev_images])
        head, hist = train_classifier(feats, labels, epochs=EPOCHS, lr=LR,
                                      seed=seed, device=dev)
        with torch.no_grad():
            logits = head(torch.from_numpy(ev_feats).to(dev)).cpu().numpy()
        np.savez(os.path.join(args.out, "features_seed%d.npz" % seed),
                 feats=feats, labels=labels, ev_feats=ev_feats,
                 ev_labels=ev_labels)
        print(json.dumps({"seed": seed, "device": str(dev),
                          "port_card": metrics(logits.argmax(-1) == 1,
                                               ev_labels),
                          "val_acc": hist["val_acc"]}), flush=True)


def cpu(args):
    import numpy as np
    import jax
    import jax.numpy as jnp
    import torch
    from soccerplayershapepose_tpu.models.classifier import ClassifyNet
    from soccerplayershapepose_tpu.pipeline import classification as jcls
    from soccerplayershapepose_torch import convert
    from soccerplayershapepose_torch.models.classifier import (
        ClassifyNet as TClassifyNet)
    from soccerplayershapepose_torch.pipeline import classification as tcls

    jax.config.update("jax_platforms", "cpu")
    rows = []
    for path in sorted(glob.glob(os.path.join(args.out,
                                              "features_seed*.npz"))):
        seed = int(os.path.basename(path)[len("features_seed"):-4])
        z = np.load(path)
        params, _ = jcls.train_classifier(z["feats"], z["labels"],
                                          epochs=EPOCHS, lr=LR, seed=seed)
        jlogits = np.asarray(ClassifyNet().apply(params,
                                                 jnp.asarray(z["ev_feats"])))
        init = ClassifyNet().init(jax.random.PRNGKey(seed),
                                  jnp.zeros((1, z["feats"].shape[1])))
        carried = TClassifyNet()
        carried.load_state_dict(convert.classifier_state_dict_from_flat(
            convert.flatten_tree({"head": jax.device_get(init)}))["head"])
        row = {"seed": seed,
               "jax_cpu": metrics(jlogits.argmax(-1) == 1, z["ev_labels"])}
        for name, head0 in (("port_cpu", None),
                            ("port_cpu_from_jax_init", carried)):
            head, _ = tcls.train_classifier(z["feats"], z["labels"],
                                            epochs=EPOCHS, lr=LR, seed=seed,
                                            head=head0, device="cpu")
            with torch.no_grad():
                tlogits = head(torch.from_numpy(z["ev_feats"])).numpy()
            row[name] = metrics(tlogits.argmax(-1) == 1, z["ev_labels"])
        rows.append(row)
        print(json.dumps(row), flush=True)
    for who in ("jax_cpu", "port_cpu", "port_cpu_from_jax_init"):
        print(json.dumps({who: {k: [float(np.mean([r[who][k] for r in rows])),
                                    float(np.std([r[who][k] for r in rows]))]
                                for k in rows[0][who]}}))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=["card", "cpu"])
    p.add_argument("--out", required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[3, 4, 5, 6, 7, 8])
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    (card if args.mode == "card" else cpu)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
