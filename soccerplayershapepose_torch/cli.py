"""Command-line interface of the port's folder-tree stages.

Counterpart of ``soccerplayershapepose_tpu/cli.py``, with its flags, over
the same ``<root>/<game>/<scene>/<player>/<view>`` trees:

    python -m soccerplayershapepose_torch create-proxy --image-root ... --proxy-root ...
    python -m soccerplayershapepose_torch predict --image-root ... --proxy-root ... --result-root ...
    python -m soccerplayershapepose_torch single-view ...
    python -m soccerplayershapepose_torch multi-view ... --single-view-root ...
    python -m soccerplayershapepose_torch broad-view ... --multi-view-root ...
    python -m soccerplayershapepose_torch calc-metrics --root ...
    python -m soccerplayershapepose_torch harvest-frames --video ... --out-root ...
    python -m soccerplayershapepose_torch crop-broad-player --frame-root ... --box-root ...
    python -m soccerplayershapepose_torch detect-players --frame-root ... --out-root ...
    python -m soccerplayershapepose_torch crop-player --image-root ... --out-root ...
    python -m soccerplayershapepose_torch train --image-root ... --target-root ...
    python -m soccerplayershapepose_torch train-perception --out ... --model proxynet|detector

Each stage runs on ``--device`` (default ``cuda``; it refuses to start
where there is no card rather than fall back to the CPU; ``--device cpu``
runs the plain PyTorch path) and prints one JSON line last. The regressor
is the committed ``weights/regressor*_f16.npz`` (the random seeded one if
there is none), the detector ``weights/detector*_f16.npz`` at its measured
best-F1 score threshold (the sibling ``.json``), the frame classifier the
bundle given to ``harvest-frames --classifier-params``; ``--checkpoint``
imports a reference ``.tar`` regressor instead (``io/torch_import.py``)
and exits non-zero where the file does not exist. ``train`` runs the
distillation trainer (``drivers/training.py``) and prints
``{"best_epoch", "best_val"}``. ``train-perception`` trains ProxyNet (at
``--wh``², ``--batch-size`` crops a step) or the detector (256 × 448
frames, half the batch size, at least 1) from flax's initialisers on the
synthetic factory (``train/perception.py``) and writes the weights in the
JAX package's flat npz layout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs the plain PyTorch path)")


def _add_fit_args(p: argparse.ArgumentParser):
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--no-silhouette", action="store_true",
                   help="joints-only loss (faster; reference uses both)")
    p.add_argument("--render-wh", type=int, default=None,
                   help="silhouette render resolution (default: proxy 512)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--smpl-dir", default=None,
                   help="SMPL asset dir (synthetic model if absent)")
    p.add_argument("--checkpoint", default=None,
                   help="reference straps .tar checkpoint to import")
    p.add_argument("--conf-weight", action="store_true",
                   help="weight the joints2D fit loss by the keypoint "
                        "score channel of *_j2d.xml")
    p.add_argument("--betas-prior", type=float, default=0.0)
    p.add_argument("--pose-prior", type=float, default=0.0)
    p.add_argument("--ortho-prior", type=float, default=0.0,
                   help="rotation-manifold prior weight on the free 3x3s")
    p.add_argument("--silh-warmup", type=int, default=0,
                   help="linear silhouette-loss warmup iterations")
    p.add_argument("--joints2d-scale", type=float, default=1.0,
                   help="multiplier on the raw joints2D fit loss; ~1e6 "
                        "puts joint evidence on par with the reference's "
                        "1e6-weighted silhouette sum (FitConfig docs)")
    _add_device_arg(p)


def _build_fit_cfg(args, default_iters, default_lr):
    from soccerplayershapepose_torch.fit import FitConfig
    kw = {}
    kw["iters"] = args.iters if args.iters is not None else default_iters
    kw["lr"] = args.lr if args.lr is not None else default_lr
    if args.no_silhouette:
        kw["use_silhouette"] = False
        kw["silhouette_metrics"] = False
    if args.render_wh:
        kw["render_wh"] = args.render_wh
    kw["joint_conf_weighting"] = args.conf_weight
    kw["betas_prior"] = args.betas_prior
    kw["pose_prior"] = args.pose_prior
    kw["rot_ortho_prior"] = args.ortho_prior
    kw["silh_warmup_iters"] = args.silh_warmup
    kw["joints2d_scale"] = args.joints2d_scale
    return FitConfig(**kw)


def _load_runtime(args):
    """(device, SMPL assets, regressor_fn) of a stage subcommand."""
    from soccerplayershapepose_torch.convert import (
        default_weights_path, load_regressor_weights)
    from soccerplayershapepose_torch.pipeline.predict import (
        build_predictor, predict_smpl)
    from soccerplayershapepose_torch.smpl import load_assets
    from soccerplayershapepose_torch.utils.precision import default_device
    if args.checkpoint and not os.path.exists(args.checkpoint):
        # Never carry on with other weights than the ones asked for.
        raise SystemExit(f"--checkpoint {args.checkpoint}: no such file")
    dev = default_device(args.device)
    assets = load_assets(model_dir=args.smpl_dir, device=dev)
    if args.checkpoint:
        from soccerplayershapepose_torch.io.torch_import import (
            load_straps_checkpoint)
        model = load_straps_checkpoint(args.checkpoint, device=dev)
        print(f"regressor weights: {args.checkpoint}")
    else:
        path = default_weights_path("regressor")
        if path is None:
            _, fn = build_predictor(device=dev)
            return dev, assets, fn
        model = load_regressor_weights(path, dev)
        print(f"regressor weights: {path}")

    def fn(assets_, silhouette, joints2d):
        return predict_smpl(model, assets_, silhouette, joints2d, device=dev)

    return dev, assets, fn


def _require_weights(kind: str) -> str:
    """The committed weights artifact, or exit with guidance."""
    from soccerplayershapepose_torch.convert import default_weights_path
    path = default_weights_path(kind)
    if path is None:
        raise SystemExit(
            f"no --weights given and no committed weights/{kind}*_f16.npz "
            "artifact found")
    return path


def _resolve_score_thresh(args, weights: str) -> float:
    """--score-thresh, else the weights artifact's measured best-F1
    operating point (its sibling .json), else 0.7."""
    if args.score_thresh is not None:
        return args.score_thresh
    meta = os.path.splitext(weights)[0] + ".json"
    if os.path.exists(meta):
        try:
            with open(meta) as f:
                t = json.load(f).get("best_f1_score_thresh")
            if t and 0.0 < t < 1.0:
                return float(t)
        except (OSError, ValueError, AttributeError):
            pass
    from soccerplayershapepose_torch import config as cfg
    return cfg.DETECTION_SCORE_THRESH


def _add_detector_args(p: argparse.ArgumentParser, width: int,
                       batch_size: int):
    p.add_argument("--weights", default=None,
                   help="detector weights .npz (default: committed "
                        "weights/detector*_f16.npz artifact)")
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=width)
    p.add_argument("--batch-size", type=int, default=batch_size)
    p.add_argument("--score-thresh", type=float, default=None,
                   help="detection score threshold (default: the weights "
                        "artifact's measured best-F1 operating point, else "
                        "0.7)")
    p.add_argument("--flip-tta", action="store_true",
                   help="horizontal-flip ensemble for detections")
    _add_device_arg(p)


def _detector_runner(args):
    from soccerplayershapepose_torch.convert import load_detector_weights
    from soccerplayershapepose_torch.pipeline.extract import (
        PlayerDetectorRunner)
    weights = args.weights or _require_weights("detector")
    model = load_detector_weights(weights, args.device)
    return PlayerDetectorRunner(
        model, (args.height, args.width),
        score_thresh=_resolve_score_thresh(args, weights),
        flip_tta=args.flip_tta, device=args.device)


def main(argv=None) -> int:
    from soccerplayershapepose_torch import config as cfg

    parser = argparse.ArgumentParser(prog="soccerplayershapepose_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    for name in ("predict", "single-view", "broad-view"):
        p = sub.add_parser(name)
        p.add_argument("--image-root", required=True)
        p.add_argument("--proxy-root", required=True)
        p.add_argument("--result-root", required=True)
        if name == "broad-view":
            p.add_argument("--multi-view-root", required=True)
            p.add_argument("--is-refine", action="store_true")
        if name == "single-view":
            p.add_argument("--is-refine", action="store_true")
            p.add_argument("--mul-folder", default=None)
            p.add_argument("--skip-existing", action="store_true")
        _add_fit_args(p)

    p = sub.add_parser("multi-view")
    p.add_argument("--image-root", required=True)
    p.add_argument("--proxy-root", required=True)
    p.add_argument("--single-view-root", required=True)
    p.add_argument("--result-root", required=True)
    _add_fit_args(p)

    p = sub.add_parser("calc-metrics")
    p.add_argument("--root", required=True)
    p.add_argument("--score-thresh", type=float,
                   default=cfg.REFINE_SCORE_THRESH)

    p = sub.add_parser("train")
    p.add_argument("--image-root", required=True)
    p.add_argument("--proxy-root", required=True)
    p.add_argument("--target-root", required=True)
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--train-set", default=None,
                   help="train_set.xml game split file")
    p.add_argument("--epochs", type=int, default=cfg.REGRESSOR_TRAIN_EPOCHS)
    p.add_argument("--lr", type=float, default=cfg.REGRESSOR_TRAIN_LR)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--smpl-dir", default=None)
    _add_device_arg(p)

    p = sub.add_parser("train-perception",
                       help="train ProxyNet or the detector on synthetic "
                            "SMPL renders")
    p.add_argument("--out", required=True, help="output weights .npz")
    p.add_argument("--model", choices=["proxynet", "detector"],
                   default="proxynet")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--wh", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--no-iuv", action="store_true")
    p.add_argument("--smpl-dir", default=None)
    _add_device_arg(p)

    p = sub.add_parser("create-proxy",
                       help="proxy extraction from raw crops on the card")
    p.add_argument("--image-root", required=True)
    p.add_argument("--proxy-root", required=True)
    p.add_argument("--vis-root", default=None)
    p.add_argument("--weights", default=None,
                   help="ProxyNet weights .npz (default: committed "
                        "weights/proxynet*_f16.npz artifact)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--write-iuv", action="store_true")
    p.add_argument("--no-iuv", action="store_true")
    p.add_argument("--no-flip-tta", action="store_true",
                   help="disable the horizontal-flip mask/IUV ensemble "
                        "(default on; one 2B-batch forward)")
    _add_device_arg(p)

    p = sub.add_parser("detect-players",
                       help="detect and crop players from raw frames")
    p.add_argument("--frame-root", required=True)
    p.add_argument("--out-root", required=True)
    _add_detector_args(p, width=448, batch_size=4)

    p = sub.add_parser("crop-player",
                       help="per-view centre-player crops over a "
                            "<game>/<scene>/<player>/<view> tree")
    p.add_argument("--image-root", required=True)
    p.add_argument("--out-root", required=True)
    p.add_argument("--keep-player-one", action="store_true")
    p.add_argument("--skip-if-present", default=None,
                   help="broadcast tree root (check_board semantics)")
    p.add_argument("--save-mid", action="store_true")
    _add_detector_args(p, width=256, batch_size=8)

    p = sub.add_parser("crop-broad-player",
                       help="broadcast boxes.xml + vis, then index.xml-"
                            "driven player crops")
    p.add_argument("--frame-root", required=True)
    p.add_argument("--box-root", required=True)
    p.add_argument("--vis-root", default=None)
    p.add_argument("--player-root", default=None,
                   help="also write <index>/player.png crops here")
    _add_detector_args(p, width=448, batch_size=4)

    p = sub.add_parser("harvest-frames",
                       help="match video -> classified <game>/<scene> "
                            "frame tree")
    p.add_argument("--video", required=True, nargs="+",
                   help="one or more video files")
    p.add_argument("--out-root", required=True)
    p.add_argument("--classifier-params", default=None,
                   help="frame classifier bundle .npz "
                        "(pipeline/classification.py); omit to accept "
                        "every sampled frame")
    p.add_argument("--n-samples", type=int, default=500,
                   help="random frames sampled per video")
    p.add_argument("--max-accepted", type=int, default=200,
                   help="accepted frames kept per video")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    _add_device_arg(p)

    args = parser.parse_args(argv)

    if args.command == "harvest-frames":
        from soccerplayershapepose_torch.pipeline.classification import \
            load_classifier
        from soccerplayershapepose_torch.pipeline.video import \
            harvest_frames_stage
        from soccerplayershapepose_torch.utils.precision import \
            default_device
        default_device(args.device)
        gate = (load_classifier(args.classifier_params, args.device)
                if args.classifier_params else None)
        results = []
        for k, video in enumerate(args.video):
            results.append(harvest_frames_stage(
                video, args.out_root, classifier=gate,
                n_samples=args.n_samples, max_accepted=args.max_accepted,
                seed=args.seed + k, size_hw=(args.height, args.width)))
        print(json.dumps({"videos": results,
                          "accepted": sum(r["accepted"] for r in results)}))
        return 0

    if args.command == "detect-players":
        from soccerplayershapepose_torch.pipeline.extract import (
            detect_players_stage)
        out = detect_players_stage(_detector_runner(args), args.frame_root,
                                   args.out_root, batch_size=args.batch_size)
        print(json.dumps(out))
        return 0

    if args.command == "crop-player":
        from soccerplayershapepose_torch.pipeline.extract import (
            crop_player_stage)
        out = crop_player_stage(
            _detector_runner(args), args.image_root, args.out_root,
            batch_size=args.batch_size,
            skip_player_one=not args.keep_player_one,
            skip_if_present_root=args.skip_if_present,
            save_mid=args.save_mid)
        print(json.dumps(out))
        return 0

    if args.command == "crop-broad-player":
        from soccerplayershapepose_torch.pipeline.extract import (
            crop_broad_player_images_stage, crop_broad_player_stage)
        out = crop_broad_player_stage(_detector_runner(args), args.frame_root,
                                      args.box_root, args.vis_root,
                                      batch_size=args.batch_size)
        if args.player_root:
            out["images"] = crop_broad_player_images_stage(
                args.box_root, args.frame_root, args.player_root)
        print(json.dumps(out))
        return 0

    if args.command == "calc-metrics":
        from soccerplayershapepose_torch.io import calc_metrics
        print(json.dumps(calc_metrics(args.root, args.score_thresh)))
        return 0

    if args.command == "train":
        from soccerplayershapepose_torch.drivers.training import (
            read_train_split, train_regressor)
        from soccerplayershapepose_torch.smpl import load_assets
        from soccerplayershapepose_torch.utils.precision import \
            default_device
        dev = default_device(args.device)
        assets = load_assets(model_dir=args.smpl_dir, device=dev)
        split = read_train_split(args.train_set) if args.train_set else None
        out = train_regressor(assets, args.image_root, args.proxy_root,
                              args.target_root, args.checkpoint_dir,
                              train_games=split, epochs=args.epochs,
                              learning_rate=args.lr, resume=args.resume,
                              device=dev)
        print(json.dumps({"best_epoch": out["best_epoch"],
                          "best_val": {k: float(v)
                                       for k, v in out["best_val"].items()}}))
        return 0

    if args.command == "train-perception":
        from soccerplayershapepose_torch.smpl import load_assets
        from soccerplayershapepose_torch.train.perception import (
            save_perception_weights, train_detector_synth,
            train_proxynet_synth)
        from soccerplayershapepose_torch.utils.precision import \
            default_device
        dev = default_device(args.device)
        assets = load_assets(model_dir=args.smpl_dir, device=dev)
        if args.model == "proxynet":
            state = train_proxynet_synth(
                assets, steps=args.steps, batch=args.batch_size, wh=args.wh,
                learning_rate=args.lr, with_iuv=not args.no_iuv, device=dev)
        else:
            state = train_detector_synth(
                assets, steps=args.steps, batch=max(1, args.batch_size // 2),
                learning_rate=args.lr, device=dev)
        save_perception_weights(args.out, state.model)
        print(json.dumps({"weights": args.out, "steps": args.steps}))
        return 0

    if args.command == "create-proxy":
        from soccerplayershapepose_torch.convert import load_proxynet_weights
        from soccerplayershapepose_torch.pipeline.extract import (
            ProxyExtractor, create_proxy_stage)
        weights = args.weights or _require_weights("proxynet")
        model = load_proxynet_weights(weights, args.device,
                                      with_iuv=not args.no_iuv)
        extractor = ProxyExtractor(model, flip_tta=not args.no_flip_tta,
                                   device=args.device)
        out = create_proxy_stage(extractor, args.image_root, args.proxy_root,
                                 vis_root=args.vis_root,
                                 batch_size=args.batch_size,
                                 write_iuv=args.write_iuv)
        print(json.dumps(out))
        return 0

    dev, assets, fn = _load_runtime(args)
    from soccerplayershapepose_torch.drivers import (
        broad_view_optimization, multi_view_optimization, predict_stage,
        single_view_optimization)

    if args.command == "predict":
        n = predict_stage(assets, args.proxy_root, args.image_root,
                          args.result_root, regressor_fn=fn,
                          batch_size=args.batch_size, device=dev)
        print(json.dumps({"views": n}))
    elif args.command == "single-view":
        out = single_view_optimization(
            assets, args.image_root, args.proxy_root, args.result_root,
            regressor_fn=fn,
            fit_cfg=_build_fit_cfg(args, cfg.SINGLE_VIEW_ITERS,
                                   cfg.FITTING_LR),
            batch_size=args.batch_size, is_refine=args.is_refine,
            mul_folder=args.mul_folder, skip_existing=args.skip_existing,
            device=dev)
        print(json.dumps(out))
    elif args.command == "multi-view":
        out = multi_view_optimization(
            assets, args.image_root, args.proxy_root, args.single_view_root,
            args.result_root,
            fit_cfg=_build_fit_cfg(args, cfg.MULTI_VIEW_ITERS,
                                   cfg.FITTING_LR),
            batch_size=max(1, args.batch_size // 4), device=dev)
        print(json.dumps(out))
    elif args.command == "broad-view":
        out = broad_view_optimization(
            assets, args.image_root, args.proxy_root, args.multi_view_root,
            args.result_root, regressor_fn=fn,
            fit_cfg=_build_fit_cfg(args, cfg.BROAD_VIEW_ITERS,
                                   cfg.BROAD_VIEW_LR),
            batch_size=args.batch_size, is_refine=args.is_refine,
            device=dev)
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
