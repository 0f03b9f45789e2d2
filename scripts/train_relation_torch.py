"""Train and evaluate the pose relation module with the PyTorch port.

The counterpart of ``scripts/train_relation.py``:

* ``train`` (the default) trains v0 (27 relation units of width 8) or, with
  ``--v1``, the lifted 1024-wide variant on synthetic correlated scenes
  (``train/relation.py:train_relation``), evaluates its denoising on
  ``--eval-batches`` held-out batches (``evaluate_relation``) and writes
  ``relation_{v0,v1}.npz`` (the flat flax layout either package reads) and
  ``relation_{v0,v1}_eval.json`` into ``--out-dir``;
* ``relate`` runs ``drivers/training.py:evaluate_model`` and
  ``evaluate_model_relate`` over a minted distillation tree (``--root``:
  ``broad_images/``, ``broad_proxies/``, ``broad/`` and the scenes' boxes
  under ``scenes/``) with the committed regressor and relation weights,
  and writes ``relate_eval_{v0,v1}.json`` into ``--out-dir``.

Both modes write only into ``--out-dir``, which must be given: the
committed records under ``weights/`` are never the default. Runs on the
CUDA card unless ``--device cpu`` (or ``--cpu``) is given; without a card
it exits non-zero.

    python3 scripts/train_relation_torch.py train --out-dir /tmp/rel
    python3 scripts/train_relation_torch.py train --steps 20 --batch 2 \\
        --players 4 --eval-batches 2 --out-dir /tmp/rel --device cpu
    python3 scripts/train_relation_torch.py relate --root /tmp/distill \\
        --v1 --out-dir /tmp/rel
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def cmd_train(args, relation=None, batches=None):
    """Train, evaluate and save one variant; ``relation`` (a module to
    train in place) and ``batches`` (one dict of tensors per step) replace
    the seeded initial weights and batches. Returns the evaluation's
    record."""
    from soccerplayershapepose_torch.smpl import load_assets
    from soccerplayershapepose_torch.train.relation import (
        evaluate_relation, save_relation_weights, train_relation)
    from soccerplayershapepose_torch.utils.precision import default_device

    dev = default_device(args.device)
    tag = "v1" if args.v1 else "v0"
    t0 = time.time()
    relation, history = train_relation(
        steps=args.steps, b=args.batch, n_players=args.players, lr=args.lr,
        lift_dim=1024 if args.v1 else None, seed=args.seed,
        log_every=args.log_every, device=dev, relation=relation,
        batches=batches)
    out = evaluate_relation(relation, load_assets(),
                            n_batches=args.eval_batches, b=args.batch,
                            n_players=args.players, device=dev)
    out.update(variant=tag, steps=args.steps,
               train_wall_s=round(time.time() - t0, 1),
               history_tail=history[-3:])
    os.makedirs(args.out_dir, exist_ok=True)
    dst = os.path.join(args.out_dir, "relation_%s.npz" % tag)
    save_relation_weights(dst, relation)
    out["weights"] = dst
    print(json.dumps(out), flush=True)
    with open(os.path.join(args.out_dir, "relation_%s_eval.json" % tag),
              "w") as f:
        json.dump(out, f, indent=1)
    out["history"] = history
    return out


def cmd_relate(args):
    """``evaluate_model`` and ``evaluate_model_relate`` over the tree at
    ``--root``, with and without the relation module."""
    from soccerplayershapepose_torch.convert import (
        load_regressor_weights, load_relation_weights)
    from soccerplayershapepose_torch.drivers.training import (
        evaluate_model, evaluate_model_relate)
    from soccerplayershapepose_torch.smpl import load_assets
    from soccerplayershapepose_torch.train.distill import make_train_state
    from soccerplayershapepose_torch.train.relation import V1_KWARGS
    from soccerplayershapepose_torch.utils.precision import default_device

    dev = default_device(args.device)
    tag = "v1" if args.v1 else "v0"
    assets = load_assets()
    state = make_train_state(load_regressor_weights(
        os.path.join(REPO, "weights", "regressor_18ch_f16.npz"), dev))
    relation = load_relation_weights(
        os.path.join(REPO, "weights", "relation_%s.npz" % tag), dev)
    roots = dict(image_root=os.path.join(args.root, "broad_images"),
                 proxy_root=os.path.join(args.root, "broad_proxies"),
                 target_root=os.path.join(args.root, "broad"))
    base = evaluate_model(assets, state=state, **roots)
    relate = evaluate_model_relate(
        assets, state=state, relation=relation,
        boxes_root=os.path.join(args.root, "scenes"),
        relation_kwargs=V1_KWARGS if args.v1 else {},
        optimize_cam=args.optimize_cam, **roots)
    out = {"variant": tag, "without_relation": base,
           "with_relation": relate,
           "note": ("evaluate_model_relate on the minted distill tree vs "
                    "broad-view pseudo-GT; boxes from scenes/*/boxes.xml; "
                    "relation weights trained on synth correlated scenes "
                    "(train/relation.py)")}
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "relate_eval_%s.json" % tag),
              "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


def build_parser():
    p = argparse.ArgumentParser(
        description="Train and evaluate the relation module (PyTorch port "
                    "of scripts/train_relation.py)")
    p.add_argument("mode", nargs="?", default="train",
                   choices=["train", "relate"])
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--players", type=int, default=6)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-batches", type=int, default=8)
    p.add_argument("--log-every", type=int, default=200)
    p.add_argument("--v1", action="store_true",
                   help="lifted 1024-dim variant (regressor_relate1.py)")
    p.add_argument("--root", default=None,
                   help="relate: the minted distillation tree")
    p.add_argument("--optimize-cam", action="store_true")
    p.add_argument("--out-dir", required=True,
                   help="where the weights and records go (never weights/ "
                        "by default)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the CUDA card)")
    p.add_argument("--cpu", action="store_true",
                   help="the same as --device cpu")
    return p


def parse_args(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    if args.mode == "relate" and not args.root:
        p.error("relate needs --root")
    return args


def main(argv=None):
    args = parse_args(argv)
    import torch
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("train_relation_torch: CUDA is not available; pass "
              "--device cpu (or --cpu) to run on the CPU", file=sys.stderr)
        return 2
    {"train": cmd_train, "relate": cmd_relate}[args.mode](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
