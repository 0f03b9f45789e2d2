"""The distillation circle on the PyTorch port, end to end.

The port's counterpart of ``scripts/distill_circle.py`` (and of
``scripts/train_relation.py``'s relate mode and relation training): the
synthetic scene factory makes a broadcast dataset whose generating 3-D
parameters are known; the stage drivers mint broadcast-view fits as pseudo
ground truth; the regressor is retrained on them; and every link is scored
against the real ground truth. Imports nothing of JAX.

Phases (each output-guarded: rerun freely; ``all`` runs them in order):
  make-data  games x scenes x players, V narrow views + the broad view,
             corrupted proxies and clean GT (``train/scenes.py``)
  mint       single-view -> multi-view -> broad-view stages over the tree
             (``drivers/stages.py``) => pseudo-GT npz per player
  train      ``drivers/training.train_regressor`` warm-started from the
             committed regressor => the best epoch's parameters with the
             last BN statistics, as the JAX circle packs them, and the
             last epoch's weights (fp16 npz)
  eval       held-out games vs GT-3D: the pseudo-GT, the teacher stages,
             the committed, the distilled and the last epoch's regressor
             on the same broadcast proxies
  relate     ``evaluate_model`` and ``evaluate_model_relate`` with the
             committed relation weights v0 and v1 (boxes from scenes/)
  relation   ``train_relation`` v0 (3000 steps) and v1 (4000), each held
             out on 64 batches of 8 scenes

Outputs go under ``--out`` (default ``<root>/records``), never under
``weights/``: ``mint_summary.json``, ``train_history.json``,
``distill_eval.json``, ``relate_eval_v{0,1}.json``,
``relation_v{0,1}_eval.json`` and ``walls.json`` (seconds per phase).

Usage (on the card; ``--device cpu`` with ``--fast`` and a small tree
rehearses it). ``--root`` names a directory of this run's own: a second
run on the same root reuses the scenes and fits it finds there.
  python scripts/distill_circle_torch.py all --root "$(mktemp -d)"
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
BASE_WEIGHTS = os.path.join(REPO, "weights", "regressor_18ch_f16.npz")
REL_WEIGHTS = os.path.join(REPO, "weights", "relation_v%d.npz")


def _games(args):
    return [f"game{g}" for g in range(args.games)]


def val_games(args):
    """The last ~20% of the games are held out."""
    games = _games(args)
    return games[max(1, int(len(games) * 0.8)):]


def _out(args, name):
    os.makedirs(args.out, exist_ok=True)
    return os.path.join(args.out, name)


def _save(args, name, obj):
    with open(_out(args, name), "w") as f:
        json.dump(obj, f, indent=1)


def _load(args, name):
    path = _out(args, name)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def _assets(args):
    from soccerplayershapepose_torch.smpl import load_assets
    from soccerplayershapepose_torch.utils.precision import default_device
    return load_assets(device=default_device(args.device))


def cmd_make_data(args):
    import torch
    from soccerplayershapepose_torch.train import scenes
    assets = _assets(args)
    made = 0
    for g, game in enumerate(_games(args)):
        for s in range(args.scenes):
            name = f"scene{s}"
            if os.path.exists(os.path.join(args.root, "scenes", game, name,
                                           "ball.xml")):
                continue
            seed = args.seed * 1_000_000 + g * 1000 + s
            draws = scenes.sample_scene_views_draws(
                torch.Generator().manual_seed(seed), args.players,
                args.views)
            data = scenes.synth_scene_views(assets, draws, wh=args.wh)
            corr = scenes.sample_tree_corruption(
                torch.Generator().manual_seed(seed + 99), data)
            scenes.write_scene_tree(args.root, game, name, data,
                                    corruption=corr, write_images=False)
            made += 1
    print(f"make-data: {made} scenes written to {args.root}", flush=True)


def _fit_cfg(args, iters, lr=None):
    from soccerplayershapepose_torch.fit import FitConfig
    # The knobs measured to improve 3-D (weights/fit3d_benchmark_r04d.json).
    return FitConfig(iters=iters, lr=lr or 0.001, proxy_wh=args.wh,
                     render_wh=min(args.wh, 256), joints2d_scale=1e6,
                     joint_conf_weighting=True, betas_prior=0.01,
                     rot_ortho_prior=0.05)


def _regressor_fn(args):
    from soccerplayershapepose_torch.convert import load_regressor_weights
    from soccerplayershapepose_torch.pipeline.predict import predict_smpl
    model = load_regressor_weights(BASE_WEIGHTS, args.device)

    def fn(assets, silhouette, joints2d):
        return predict_smpl(model, assets, silhouette, joints2d,
                            device=args.device)
    return fn


def cmd_mint(args):
    from soccerplayershapepose_torch import config as cfg
    from soccerplayershapepose_torch.drivers import stages
    assets = _assets(args)
    fn = _regressor_fn(args)
    r = {k: os.path.join(args.root, k) for k in (
        "images", "proxies", "broad_images", "broad_proxies", "sgl", "mul",
        "broad")}
    summary = _load(args, "mint_summary.json") or {}
    sv_iters = 4 if args.fast else cfg.SINGLE_VIEW_ITERS
    mv_rounds = 1 if args.fast else cfg.MULTI_VIEW_ROUNDS
    mv_iters = 4 if args.fast else cfg.MULTI_VIEW_ITERS
    bd_iters = 4 if args.fast else cfg.BROAD_VIEW_ITERS
    steps = (
        ("single", lambda: stages.single_view_optimization(
            assets, r["images"], r["proxies"], r["sgl"], regressor_fn=fn,
            fit_cfg=_fit_cfg(args, sv_iters), batch_size=args.batch,
            skip_existing=True, verbose=False, device=args.device)),
        ("multi", lambda: stages.multi_view_optimization(
            assets, r["images"], r["proxies"], r["sgl"], r["mul"],
            fit_cfg=_fit_cfg(args, mv_iters),
            batch_size=max(args.batch // 4, 2), rounds=mv_rounds,
            iters_per_phase=mv_iters, verbose=False, device=args.device)),
        ("broad", lambda: stages.broad_view_optimization(
            assets, r["broad_images"], r["broad_proxies"], r["mul"],
            r["broad"], regressor_fn=fn,
            fit_cfg=_fit_cfg(args, bd_iters, cfg.BROAD_VIEW_LR),
            batch_size=args.batch, verbose=False, device=args.device)))
    for name, run in steps:
        if name in summary:
            continue
        t0 = time.time()
        summary[name] = run()
        summary[name + "_wall_s"] = round(time.time() - t0, 1)
        _save(args, "mint_summary.json", summary)
        print(name + ":", json.dumps(summary[name]), flush=True)


def cmd_train(args):
    import numpy as np
    from soccerplayershapepose_torch.drivers.training import train_regressor
    from soccerplayershapepose_torch.convert import (
        regressor_flat_from_state_dict)
    from soccerplayershapepose_torch.train.straps import (
        save_regressor_weights)
    assets = _assets(args)
    ckpt = args.ckpt
    out = train_regressor(
        assets, os.path.join(args.root, "broad_images"),
        os.path.join(args.root, "broad_proxies"),
        os.path.join(args.root, "broad"), ckpt,
        train_games=[g for g in _games(args) if g not in set(val_games(args))],
        epochs=args.epochs, learning_rate=args.lr,
        max_players=args.players + 2,
        log_path=os.path.join(ckpt, "tracker.pkl"), seed=args.seed,
        resume=os.path.isdir(os.path.join(ckpt, "latest")),
        init_weights=BASE_WEIGHTS, device=args.device)
    # The best epoch's parameters with the last BN statistics, as the JAX
    # circle packs them.
    stats = {k: v for k, v in regressor_flat_from_state_dict(
        out["state"].regressor.state_dict()).items()
        if k.startswith("batch_stats/")}
    flat = {"params/" + k: v for k, v in out["best_params"].items()}
    flat.update(stats)
    np.savez(_out(args, "regressor_18ch_distilled.npz"),
             **{k: v.astype(np.float16) for k, v in flat.items()})
    # The last epoch's weights, whose parameters and BN statistics belong
    # together.
    save_regressor_weights(_out(args, "regressor_18ch_last.npz"),
                           out["state"].regressor, dtype=np.float16)
    hist = {k: [float(x) for x in v] for k, v in out["history"].items()
            if k.startswith(("train_", "val_"))
            and k.split("_", 1)[1] in ("pves_pa", "mpjpes_pa", "loss")}
    rec = {"best_epoch": out["best_epoch"],
           "best_val": {k: float(v) for k, v in out["best_val"].items()},
           "history": hist}
    _save(args, "train_history.json", rec)
    print(json.dumps({k: rec[k] for k in ("best_epoch", "best_val")}),
          flush=True)


def _gt_rows(args, tree, views):
    """(fit or proxy row, GT) pairs of the held-out games."""
    import numpy as np
    from soccerplayershapepose_torch import config as cfg
    from soccerplayershapepose_torch.io import formats as io
    val = set(val_games(args))
    scale = cfg.PROXY_REP_INPUT_WH / float(args.wh)
    for node in io.walk_player_tree(os.path.join(args.root, tree)):
        if node.game not in val:
            continue
        gt_path = os.path.join(args.root, "gt", node.game, node.scene,
                               node.player, "gt.npz")
        if not os.path.exists(gt_path):
            continue
        gt = dict(np.load(gt_path))
        for v in (views or node.views):
            stem = os.path.splitext(v)[0]
            if f"{stem}_global_orient" not in gt:
                continue
            yield node, stem, {
                "pose": np.concatenate([gt[f"{stem}_global_orient"],
                                        gt["body_pose"]], 0),
                "betas": gt["betas"], "j2d": gt[f"{stem}_joints2d"] * scale}


def _metrics(assets, dev, cam, pose, betas, gts):
    import numpy as np
    import torch
    from soccerplayershapepose_torch.train.straps import rotmat_metrics

    def t(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=torch.float32)
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    m = rotmat_metrics(assets, t(cam), t(pose), t(betas),
                       t(np.stack([g["pose"] for g in gts])),
                       t(np.stack([g["betas"] for g in gts])),
                       t(np.stack([g["j2d"] for g in gts])))
    return {k: round(float(v), 2) for k, v in m.items()}


def _cam(t, wh):
    from soccerplayershapepose_torch import config as cfg
    return [2 * cfg.FOCAL_LENGTH / (wh * t[2] + 1e-9), t[0], t[1]]


def cmd_eval(args):
    import numpy as np
    import torch
    from soccerplayershapepose_torch import config as cfg
    from soccerplayershapepose_torch.convert import load_regressor_weights
    from soccerplayershapepose_torch.drivers.stages import load_proxy_batch
    from soccerplayershapepose_torch.io import formats as io
    from soccerplayershapepose_torch.models.ief import default_initial_params
    from soccerplayershapepose_torch.ops.rotations import rot6d_to_rotmat
    from soccerplayershapepose_torch.pipeline.proxy import (
        create_proxy_representation)
    assets = _assets(args)
    dev = assets.faces.device
    rows = list(_gt_rows(args, "broad_images", ["broad.png"]))
    sils, j2ds, gts = [], [], []
    for node, _, gt in rows:
        s, j = load_proxy_batch(os.path.join(
            args.root, "broad_proxies", node.game, node.scene, node.player),
            ["broad"])
        sils.append(s[0])
        j2ds.append(j[0])
        gts.append(gt)
    proxy = create_proxy_representation(
        torch.from_numpy(np.stack(sils)).to(dev),
        torch.from_numpy(np.stack(j2ds)).to(dev)[..., :2], in_wh=args.wh)
    init = default_initial_params(assets.mean_pose_rot6d, assets.mean_shape)
    out = {"n_players_val": len(rows)}
    sets = {"baseline": BASE_WEIGHTS,
            "distilled": _out(args, "regressor_18ch_distilled.npz"),
            "last_epoch": _out(args, "regressor_18ch_last.npz")}
    for name, path in sets.items():
        if not os.path.exists(path):
            continue
        model = load_regressor_weights(path, dev)
        with torch.no_grad():
            cam, pose6d, betas = model(proxy, init)
            rot = rot6d_to_rotmat(pose6d.reshape(-1, cfg.NUM_JOINTS, 6))
            out[name] = _metrics(assets, dev, cam, rot, betas, gts)
    pg = [(i, io.read_fit_npz(os.path.join(args.root, "broad", n.game,
                                           n.scene, n.player, "data.npz")))
          for i, (n, _, _) in enumerate(rows)
          if os.path.exists(os.path.join(args.root, "broad", n.game,
                                         n.scene, n.player, "data.npz"))]
    if pg:
        with torch.no_grad():
            out["pseudo_gt"] = _metrics(
                assets, dev, [_cam(d["translation"][0], args.wh)
                              for _, d in pg],
                np.stack([np.concatenate([d["global_orient"][0],
                                          d["body_pose"][0]], 0)
                          for _, d in pg]),
                np.stack([d["betas"][0] for _, d in pg]),
                [gts[i] for i, _ in pg])
    out["teacher_stages"] = _stage_metrics(args, assets, dev)
    out["val_games"] = val_games(args)
    _save(args, "distill_eval.json", out)
    print(json.dumps(out), flush=True)


def _stage_metrics(args, assets, dev):
    """GT-3D quality of the single-view and multi-view teacher stages on
    the held-out games, per view fit."""
    import numpy as np
    import torch
    from soccerplayershapepose_torch.io import formats as io
    rows = {"sgl": [], "mul": []}
    for node, stem, gt in _gt_rows(args, "images", None):
        pdir = {k: os.path.join(args.root, k, node.game, node.scene,
                                node.player) for k in rows}
        svp = os.path.join(pdir["sgl"], stem + ".npz")
        if os.path.exists(svp):
            d = io.read_fit_npz(svp)
            rows["sgl"].append((_cam(d["translation"][0], args.wh),
                                np.concatenate([d["global_orient"][0],
                                                d["body_pose"][0]], 0),
                                d["betas"][0], gt))
        if os.path.exists(os.path.join(pdir["mul"], "data.npz")):
            mv = io.read_multiview_npz(pdir["mul"])
            if stem in mv["views"]:
                vd = mv["views"][stem]
                rows["mul"].append((_cam(vd["translation"][0], args.wh),
                                    np.concatenate([vd["global_orient"][0],
                                                    mv["body_pose"][0]], 0),
                                    mv["betas"][0], gt))
    out = {}
    with torch.no_grad():
        for stage, rr in rows.items():
            if rr:
                out[stage] = _metrics(
                    assets, dev, [r[0] for r in rr],
                    np.stack([r[1] for r in rr]),
                    np.stack([r[2] for r in rr]), [r[3] for r in rr])
                out[stage]["n_view_fits"] = len(rr)
    return out


def per_scene(assets, state, roots):
    """``evaluate_model``'s metrics scene by scene: {game/scene: means}."""
    from soccerplayershapepose_torch.drivers import training
    step = training.make_eval_step()
    out = {}
    for b in training.gather_scene_batches(*roots):
        _, aux = step(state, assets, training._device_batch(b, state.device))
        sums = training._metric_sums(aux, b["mask"])
        out[b["game"] + "/" + b["scene"]] = training._means(
            dict(sums, **{"joints2D_l2es": 0.0}), b["num_real"])
    return out


def spread(scenes):
    """Mean and standard deviation over scenes of each metric."""
    import numpy as np
    keys = [k for k in next(iter(scenes.values())) if k != "num_players"]
    return {k: {"mean": float(np.mean([m[k] for m in scenes.values()])),
                "std": float(np.std([m[k] for m in scenes.values()],
                                    ddof=1)) if len(scenes) > 1 else 0.0}
            for k in keys}


def cmd_relate(args):
    from soccerplayershapepose_torch.convert import (
        load_regressor_weights, load_relation_weights)
    from soccerplayershapepose_torch.drivers.training import (
        evaluate_model, evaluate_model_relate)
    from soccerplayershapepose_torch.train.distill import make_train_state
    assets = _assets(args)
    state = make_train_state(load_regressor_weights(BASE_WEIGHTS,
                                                    args.device))
    roots = (os.path.join(args.root, "broad_images"),
             os.path.join(args.root, "broad_proxies"),
             os.path.join(args.root, "broad"))
    base = evaluate_model(assets, *roots, state)
    scenes = per_scene(assets, state, roots)
    games = {}
    for name, m in scenes.items():
        games.setdefault(name.split("/")[0], {})[name] = m
    for v in (0, 1):
        relate = evaluate_model_relate(
            assets, *roots, state,
            relation=load_relation_weights(REL_WEIGHTS % v, args.device),
            boxes_root=os.path.join(args.root, "scenes"),
            optimize_cam=args.optimize_cam)
        rec = {"variant": "v%d" % v, "without_relation": base,
               "with_relation": relate,
               "without_relation_scene_spread": spread(scenes),
               "without_relation_per_game": {
                   g: spread(s) for g, s in sorted(games.items())}}
        _save(args, "relate_eval_v%d.json" % v, rec)
        print(json.dumps(rec), flush=True)


def cmd_relation(args):
    from soccerplayershapepose_torch.train.relation import (
        evaluate_relation, save_relation_weights, train_relation)
    assets = _assets(args)
    for v, steps in ((0, args.relation_steps_v0),
                     (1, args.relation_steps_v1)):
        if _load(args, "relation_v%d_eval.json" % v):
            continue
        t0 = time.time()
        relation, history = train_relation(
            steps=steps, b=8, n_players=6, lr=1e-3,
            lift_dim=1024 if v else None, seed=args.seed, verbose=False,
            device=args.device)
        wall = round(time.time() - t0, 1)
        out = evaluate_relation(relation, assets, n_batches=64, b=8,
                                n_players=6, device=args.device)
        out.update(variant="v%d" % v, steps=steps, train_wall_s=wall,
                   history_tail=history[-3:])
        save_relation_weights(_out(args, "relation_v%d.npz" % v), relation)
        _save(args, "relation_v%d_eval.json" % v, out)
        print(json.dumps(out), flush=True)


PHASES = {"make-data": cmd_make_data, "mint": cmd_mint, "train": cmd_train,
          "eval": cmd_eval, "relate": cmd_relate, "relation": cmd_relation}


def main():
    p = argparse.ArgumentParser()
    p.add_argument("phase", choices=list(PHASES) + ["all"])
    p.add_argument("--root", required=True,
                   help="the dataset tree this run writes and reads (one "
                        "per run: make-data keeps the scenes it finds)")
    p.add_argument("--out", default=None,
                   help="records directory (default <root>/records)")
    p.add_argument("--ckpt", default=None,
                   help="train's checkpoint directory, resumed where it "
                        "holds one (default <root>/ckpt)")
    p.add_argument("--games", type=int, default=8)
    p.add_argument("--scenes", type=int, default=4)
    p.add_argument("--players", type=int, default=6)
    p.add_argument("--views", type=int, default=3)
    p.add_argument("--wh", type=int, default=512)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--lr", type=float, default=3e-5)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--relation-steps-v0", type=int, default=3000)
    p.add_argument("--relation-steps-v1", type=int, default=4000)
    p.add_argument("--optimize-cam", action="store_true",
                   help="relate: re-fit each player's orient and camera")
    p.add_argument("--fast", action="store_true",
                   help="tiny fit budgets (a CPU rehearsal of the circle)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    args.out = args.out or os.path.join(args.root, "records")
    args.ckpt = args.ckpt or os.path.join(args.root, "ckpt")
    walls = _load(args, "walls.json") or {}
    for name in (list(PHASES) if args.phase == "all" else [args.phase]):
        t0 = time.time()
        PHASES[name](args)
        walls[name] = round(time.time() - t0, 1)
        _save(args, "walls.json", walls)
        print(f"{name}: {walls[name]} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
