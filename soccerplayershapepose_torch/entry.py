"""Entry points: the predict slice as one callable, and a multi-rank dry run.

Counterpart of the JAX package's ``__graft_entry__.py``:

* :func:`entry` returns ``(fn, args)``: the batched predict slice (proxy →
  ResNet-18 + IEF → SMPL → projection, ``pipeline/predict.py:
  build_predictor``) and a batch of 32 synthetic 512² silhouettes and
  keypoints, on the card unless the caller asks for the CPU;
* :func:`dryrun_multichip` starts ``n`` gloo ranks on the CPU on an
  (n/2, 2) (data, model) grid and runs, as ``__graft_entry__.py`` does, one
  distillation step (the batch on ``data``, the IEF's large fc layers
  column-parallel on ``model``), the 2-iteration sharded single-view fit
  and one sharded ProxyNet step, each checked finite.

    python -c "from soccerplayershapepose_torch.entry import \\
        dryrun_multichip; dryrun_multichip(8)"
"""

from __future__ import annotations

import json
import multiprocessing
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from soccerplayershapepose_torch.utils.precision import (
    DeviceLike, default_device)

ENTRY_BATCH = 32
DRYRUN_LR = 1e-3
DRYRUN_TIMEOUT_S = 900


def entry(device: DeviceLike = None):
    """(fn, args): ``fn(*args)`` is the predict slice on 32 crops of 512²
    (:class:`~soccerplayershapepose_torch.pipeline.predict.PredictOutput`,
    vertices (32, 6890, 3)), with random regressor weights from seed 0, on
    ``device`` (None: the CUDA card)."""
    from soccerplayershapepose_torch.pipeline.predict import build_predictor
    from soccerplayershapepose_torch.smpl import load_assets

    dev = default_device(device)
    assets = load_assets(device=dev)
    _, fn = build_predictor(in_channels=18, resnet_layers=18, device=dev)
    rng = np.random.RandomState(0)
    b = ENTRY_BATCH
    silhouette = torch.from_numpy(
        (rng.rand(b, 512, 512) > 0.8).astype(np.float32)).to(dev)
    joints2d = torch.from_numpy(
        rng.uniform(64, 448, (b, 17, 2)).astype(np.float32)).to(dev)
    return fn, (assets, silhouette, joints2d)


def dryrun_batch(b: int) -> dict:
    """The dry run's distillation batch of ``b`` players, from a numpy
    seed, built as the drivers build theirs: elliptic 512² silhouettes and
    keypoints → the 18-channel proxy at 256² (NCHW), rotation-matrix
    targets, all rows real."""
    from soccerplayershapepose_torch.ops import batch_rodrigues
    from soccerplayershapepose_torch.pipeline.proxy import (
        create_proxy_representation)

    rs = np.random.RandomState(0)
    j2d = rs.uniform(150, 350, (b, 17, 2)).astype(np.float32)
    yy, xx = np.mgrid[:512, :512]
    c = rs.uniform(180, 330, (b, 2))
    r = rs.uniform(60, 140, (b, 2))
    sil = ((((xx[None] - c[:, :1, None]) / r[:, :1, None]) ** 2
            + ((yy[None] - c[:, 1:, None]) / r[:, 1:, None]) ** 2) < 1
           ).astype(np.float32)
    proxy = create_proxy_representation(torch.from_numpy(sil),
                                        torch.from_numpy(j2d))
    aa = rs.randn(b * 24, 3).astype(np.float32) * 0.2
    pose = batch_rodrigues(torch.from_numpy(aa)).reshape(b, 24, 3, 3)
    return {"proxy": proxy, "joints2d": torch.from_numpy(j2d),
            "target_pose": pose,
            "target_betas": torch.from_numpy(
                rs.randn(b, 10).astype(np.float32)),
            "mask": torch.ones(b)}


def dryrun_multichip(n_devices: int, out_dir: Optional[str] = None) -> dict:
    """Run the dry run on ``n_devices`` spawned gloo ranks on the CPU (one
    torch thread each) and return rank 0's summary: the grid, the
    distillation loss and metrics, the fit's joint error and best
    iterations, the ProxyNet step's loss. With ``out_dir`` rank 0 also
    writes the distillation step's gathered regressor (``regressor.npz``,
    state-dict names) and log-variances (``summary.json``) there. A rank
    that fails, or outlives DRYRUN_TIMEOUT_S, raises."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        out_dir = out_dir or tmp
        os.makedirs(out_dir, exist_ok=True)
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_dryrun_rank, args=(
            r, n_devices, init_file, out_dir)) for r in range(n_devices)]
        for p in procs:
            p.start()
        deadline = time.time() + DRYRUN_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(deadline - time.time(), 0.1))
            late = [r for r, p in enumerate(procs) if p.is_alive()]
            failed = [r for r, p in enumerate(procs) if p.exitcode]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        if late or failed:
            raise RuntimeError("dryrun_multichip(%d): ranks %s outlived %d "
                               "s, ranks %s failed" % (
                                   n_devices, late, DRYRUN_TIMEOUT_S,
                                   failed))
        with open(os.path.join(out_dir, "summary.json")) as f:
            return json.load(f)


def _finite(value: float, what: str) -> None:
    if not np.isfinite(value):
        raise RuntimeError("dryrun_multichip: non-finite %s %s"
                           % (what, value))


def _dryrun_rank(rank: int, world: int, init_file: str, out_dir: str):
    torch.set_num_threads(1)
    import torch.distributed as dist

    from soccerplayershapepose_torch.fit import (
        FitConfig, FitInit, single_view_fit)
    from soccerplayershapepose_torch.models.ief import ColumnParallelLinear
    from soccerplayershapepose_torch.models.init import flax_init_
    from soccerplayershapepose_torch.models.perception import ProxyNet
    from soccerplayershapepose_torch.parallel import (
        initialize, make_mesh, shard_batch)
    from soccerplayershapepose_torch.smpl import load_assets
    from soccerplayershapepose_torch.train import distill, synth
    from soccerplayershapepose_torch.train import perception as ptrain

    initialize("file://" + init_file, world, rank, device="cpu")
    # (world / 2, 2) for an even world, as the JAX dry run's grid.
    mp = 2 if world % 2 == 0 else 1
    n_data = world // mp
    mesh = make_mesh(model_parallel=mp)
    assets = load_assets()
    summary = {"grid": [n_data, mp], "seconds": {}}
    t = time.time()

    # The distillation step: batch on data, IEF fc layers on model.
    b = n_data * 2
    batch = dryrun_batch(b)
    state = distill.make_train_state(
        distill.new_regressor(18, seed=0, device="cpu"),
        learning_rate=DRYRUN_LR)
    distill.shard_train_state(state, mesh)
    state, metrics, _ = distill.make_train_step(mesh=mesh)(
        state, assets, shard_batch(batch, mesh))
    loss = float(metrics["loss"])
    _finite(loss, "distillation loss")
    summary["distill"] = {k: float(v) for k, v in metrics.items()}
    summary["log_vars"] = {k: float(v.detach())
                           for k, v in state.log_vars.items()}
    summary["split"] = [n for n, m in state.regressor.named_modules()
                        if isinstance(m, ColumnParallelLinear)]
    full = distill.gather_regressor(state, mesh)
    summary["seconds"]["distill"] = time.time() - t
    t = time.time()

    # The sharded single-view fit: players over data, 2 iterations.
    rows = n_data * 2
    fit_init = FitInit(body_pose=batch["target_pose"][:rows, 1:],
                       global_orient=batch["target_pose"][:rows, :1],
                       betas=torch.zeros(rows, 10),
                       cam_wp=torch.tensor([[0.9, 0.0, 0.0]]).repeat(rows, 1))
    sil = (np.random.RandomState(1).rand(rows, 64, 64) > 0.8).astype(
        np.float32)
    j2d = np.random.RandomState(2).uniform(8, 56, (rows, 17, 2)).astype(
        np.float32)
    res = single_view_fit(assets, fit_init, sil, j2d, FitConfig(
        iters=2, render_wh=16, proxy_wh=64, faces_per_chunk=2048),
        device="cpu", mesh=mesh)
    jerr = float(res.joint_err.mean())
    _finite(jerr, "fit joint error")
    summary["fit"] = {"rows": rows, "joint_err": jerr,
                      "best_iter": [int(i) for i in res.best_iter]}
    summary["seconds"]["fit"] = time.time() - t
    t = time.time()

    # One sharded ProxyNet step: one crop per data shard, global BN. Every
    # rank draws the global batch and renders its own crops.
    gen = torch.Generator().manual_seed(3)
    net = flax_init_(ProxyNet(with_iuv=True, channels=16), gen)
    pstate = ptrain.make_perception_state(net, DRYRUN_LR)
    draws = synth.sample_crop_draws(torch.Generator().manual_seed(4),
                                    n_data, image_wh=64, domain_rand=False,
                                    occluders=False)
    pbatch = synth.render_crop_batch(assets, shard_batch(draws, mesh), 64,
                                     with_image=True)
    pstate, plosses = ptrain.shard_train_step(
        ptrain.make_proxynet_train_step(), mesh)(pstate, pbatch)
    ptotal = float(plosses["total"])
    _finite(ptotal, "perception loss")
    summary["perception"] = {"b": n_data, "loss": ptotal}
    summary["seconds"]["perception"] = time.time() - t

    if rank == 0:
        np.savez(os.path.join(out_dir, "regressor.npz"),
                 **{k: v.detach().numpy() for k, v in full.items()})
        with open(os.path.join(out_dir, "summary.json"), "w") as f:
            json.dump(summary, f)
        print("dryrun_multichip(n=%d, grid=%s): loss=%.4f fit joint_err="
              "%.2f best_iter=%s perception loss=%.4f"
              % (world, summary["grid"], loss, jerr,
                 summary["fit"]["best_iter"], ptotal), flush=True)
    dist.barrier()
    dist.destroy_process_group()
