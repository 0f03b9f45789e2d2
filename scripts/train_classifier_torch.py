"""Train the main-camera frame classifier's head on synthetic broadcast data
with the PyTorch port.

The counterpart of ``scripts/train_classifier.py``. Classes, as there:

  label 1 (main camera): wide multi-player frames (256 x 448, 8 players;
    ``train/synth.py:synth_frame_batch``)
  label 0 (other shots): close-ups (one RGB crop of 256^2 filling the
    frame) and player-free pitch shots (the procedural background with its
    photometric jitter)

Frames are preprocessed as the gate does (short side 256, centre crop
224^2), featurised by a frozen :class:`FrameFeatureNet` (flax's initialisers
drawn from seed 0, as the JAX script's ``init(PRNGKey(0))`` draws them, or
the feature net of a bundle given with ``--features``), and the head is
trained by ``pipeline/classification.py:train_classifier``. A held-out set
from a disjoint seed goes through the whole gate (raw frame in) for the
accuracy, the main-camera recall and the other-shot rejection.

Writes the bundle (head and feature net, the JAX package's layout) to
``--out`` and ``<out stem>_eval.json`` beside it, and prints that json.
The committed ``weights/frame_classifier.npz`` is never the default.

    python3 scripts/train_classifier_torch.py --out /tmp/cls.npz \\
        --frames 384 --eval-frames 96 --features weights/frame_classifier.npz
    python3 scripts/train_classifier_torch.py --out /tmp/cls.npz \\
        --frames 16 --eval-frames 8 --epochs 2 --device cpu   # smoke
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def build_dataset(assets, n_frames, seed, batch=8, device=None):
    """Balanced (preprocessed (N, 224, 224, 3) float frames, (N,) int32
    labels): half main-camera wide frames, a quarter close-ups, a quarter
    player-free pitch shots, drawn from a CPU generator seeded ``seed``
    and rendered on ``device`` (None: the CUDA card)."""
    import numpy as np
    import torch
    from soccerplayershapepose_torch.pipeline.classification import \
        preprocess_frame
    from soccerplayershapepose_torch.pipeline.predict import on_device
    from soccerplayershapepose_torch.train import synth
    from soccerplayershapepose_torch.train.straps import crop_images_u8
    from soccerplayershapepose_torch.utils.precision import default_device

    dev = default_device(device)
    assets = on_device(assets, dev)
    gen = torch.Generator().manual_seed(seed)
    images, labels = [], []

    def add(img_batch, label):
        for img in crop_images_u8(img_batch).cpu().numpy():
            images.append(preprocess_frame(img))
            labels.append(label)

    n_main = n_frames // 2
    n_close = n_frames // 4
    n_bg = n_frames - n_main - n_close
    while sum(1 for lab in labels if lab == 1) < n_main:
        add(synth.synth_frame_batch(assets, gen, b=batch, n_players=8,
                                    hw=(256, 448))["image"], 1)
    while sum(1 for lab in labels if lab == 0) < n_close:
        draws = synth.sample_crop_draws(gen, batch, image_wh=256)
        add(synth.render_crop_batch(assets, draws, 256,
                                    with_image=True)["image"], 0)
    while len(labels) < n_main + n_close + n_bg:
        bg = synth.draws_to(synth.sample_background_draws(
            gen, batch, 256, 448), dev)
        photo = synth.draws_to(synth.sample_photometric_draws(
            gen, batch, 256, 448), dev)
        add(synth._photometric(photo, synth._background(bg, 256, 448)), 0)
    return np.stack(images), np.asarray(labels, np.int32)


def featurize(features, images, device, chunk=32):
    """(N, 224, 224, 3) frames → (N, 1000) features on ``device``."""
    import numpy as np
    import torch
    out = []
    with torch.no_grad():
        for i in range(0, len(images), chunk):
            x = torch.from_numpy(images[i:i + chunk]).to(device)
            out.append(features(x).cpu().numpy())
    return np.concatenate(out)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True,
                   help="bundle .npz to write (never weights/ by default)")
    p.add_argument("--frames", type=int, default=512)
    p.add_argument("--eval-frames", type=int, default=128)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--features", default=None,
                   help="classifier bundle whose feature net to use "
                        "(default: flax's initialisers, seed 0)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from soccerplayershapepose_torch.convert import load_classifier_weights
    from soccerplayershapepose_torch.models.init import flax_init_
    from soccerplayershapepose_torch.pipeline.classification import (
        FrameFeatureNet, make_frame_classifier, save_classifier,
        train_classifier)
    from soccerplayershapepose_torch.smpl import load_assets
    from soccerplayershapepose_torch.utils.precision import default_device

    dev = default_device(args.device)
    assets = load_assets(device=dev)
    t0 = time.time()
    if args.features:
        features = load_classifier_weights(args.features, dev)[1]
        if features is None:
            raise SystemExit("%s holds no feature net" % args.features)
    else:
        features = flax_init_(FrameFeatureNet(),
                              torch.Generator().manual_seed(0)).to(dev)
    features = features.eval()
    split = {}
    images, labels = build_dataset(assets, args.frames, args.seed,
                                   args.batch, dev)
    split["dataset_s"] = time.time() - t0
    t = time.time()
    feats = featurize(features, images, dev)
    split["featurize_s"] = time.time() - t
    print(f"dataset: {len(labels)} frames ({int(labels.sum())} main-camera) "
          f"in {time.time() - t0:.1f}s", flush=True)
    t = time.time()
    head, history = train_classifier(feats, labels, epochs=args.epochs,
                                     lr=args.lr, seed=args.seed, device=dev)
    split["train_s"] = time.time() - t

    # Disjoint-seed held-out evaluation through the whole gate.
    t = time.time()
    ev_images, ev_labels = build_dataset(assets, args.eval_frames,
                                         args.seed + 1_000_003, args.batch,
                                         dev)
    gate = make_frame_classifier(head, features, dev)
    preds = np.asarray([gate.process((img * 255).astype(np.uint8))
                        for img in ev_images])
    split["eval_s"] = time.time() - t
    acc = float((preds == (ev_labels == 1)).mean())
    main_recall = float(preds[ev_labels == 1].mean()) \
        if (ev_labels == 1).any() else float("nan")
    other_reject = float(1.0 - preds[ev_labels == 0].mean()) \
        if (ev_labels == 0).any() else float("nan")

    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    save_classifier(args.out, head, features)
    out = {"accuracy": acc, "main_camera_recall": main_recall,
           "other_shot_rejection": other_reject,
           "n_train": int(len(labels)), "n_eval": int(len(ev_labels)),
           "epochs": args.epochs, "val_acc_history": history["val_acc"],
           "train_loss_history": history["train_loss"],
           "features": args.features or "flax init, seed 0",
           "device": str(dev), "weights": os.path.abspath(args.out),
           "wall_s": round(time.time() - t0, 3),
           "split_s": {k: round(v, 3) for k, v in split.items()},
           "note": ("held-out synth frames, disjoint seeds; classes: wide "
                    "broadcast frames vs close-ups + player-free shots")}
    with open(os.path.splitext(args.out)[0] + "_eval.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
