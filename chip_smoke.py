#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check its kernels.

    python3 chip_smoke.py

Builds the band raster kernels from ``soccerplayershapepose_torch/csrc`` with
nvcc, holds each kernel against its plain PyTorch version on the card, runs
the single-view fit of the 22-player bench scene (512^2 targets, 256^2
render, the full synthetic SMPL mesh, random init from seed 0) through the
port's entry point, and times the kernels at the fit's shapes. Prints one
JSON line per phase, then the card's ``nvidia-smi`` name and power limit,
a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when CUDA is absent or the package is
not beside this script; exits non-zero when any check fails or the run
passes its wall-clock budget. Imports nothing of JAX.
"""

from __future__ import annotations

import faulthandler
import json
import os
import signal
import subprocess
import sys
import time

BUDGET_S = 900
DEVICE = "cuda"
PARITY_SHAPES = ((2, 128), (1, 256))   # (batch, render size)
FIT_ITERS = 20            # the stage runs 100; cut so the run stays short
FIT_BATCH = 22
FIT_RENDER_WH = 256
PROXY_WH = 512
SIGMA = 1e-5
K1_TOL = 1e-6             # max abs, fp32 sums in another order
K2_TOL = 1e-5             # relative L2, atomics sum in a run-dependent order
FIT_PARAM_TOL = 1e-4      # a tenth of one Adam step at lr 1e-3
# fp32 operations per (face, pixel) visit, counted from the kernel bodies;
# the header of csrc/band_raster.cu breaks the two counts down.
FLOPS_PER_VISIT = {"band_raster_fwd": 73, "band_raster_bwd": 93}
PEAK_FP32_FLOPS = 67e12   # H100 SXM, outside the tensor cores
PEAK_BYTES_S = 3.35e12    # H100 SXM HBM3

_T0 = time.time()


def _on_alarm(signum, frame):
    sys.stdout.write(json.dumps({"phase": "timeout", "budget_s": BUDGET_S})
                     + "\n")
    sys.stdout.flush()
    os._exit(3)


def emit(phase: str, t_start: float, **kw) -> None:
    rec = {"phase": phase, "s": round(time.time() - t_start, 3)}
    rec.update(kw)
    print(json.dumps(rec), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi gave no output (rc %d)" % out.returncode


def bench_scene(b: int, seed: int = 0):
    """The bench scene of the JAX package's bench_fit, from a numpy seed."""
    import numpy as np
    rng = np.random.RandomState(seed)
    aa = rng.randn(b, 24, 3).astype(np.float32) * 0.15
    betas = rng.randn(b, 10).astype(np.float32) * 0.5
    sil = (rng.rand(b, PROXY_WH, PROXY_WH) > 0.9).astype(np.float32)
    j2d = rng.uniform(100, 400, (b, 17, 2)).astype(np.float32)
    cam = np.tile(np.array([[0.9, 0.0, 0.0]], np.float32), (b, 1))
    return aa, betas, cam, sil, j2d


def main() -> int:
    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(BUDGET_S)
    # Backstop for a hang inside a CUDA call, where no Python handler runs.
    faulthandler.dump_traceback_later(BUDGET_S + 30, exit=True)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    try:
        from soccerplayershapepose_torch import _build
        from soccerplayershapepose_torch.utils import precision  # noqa: F401
        from soccerplayershapepose_torch.render import band_raster as br
        from soccerplayershapepose_torch.render import softras
        from soccerplayershapepose_torch.fit import FitConfig, single_view_fit
        from soccerplayershapepose_torch.fit.engine import FitInit
        from soccerplayershapepose_torch.ops import (
            batch_rodrigues, perspective_project,
            weak_perspective_to_translation, orthographic_project,
            undo_keypoint_normalisation)
        from soccerplayershapepose_torch.smpl import (
            synthesize_assets, smpl_forward)
        from soccerplayershapepose_torch import config as cfg
    except ImportError as e:
        print("chip_smoke: the port is not beside this script (%s)" % e,
              file=sys.stderr)
        return 2
    import numpy as np

    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)

    # -- env -----------------------------------------------------------------
    t = time.time()
    smi = nvidia_smi_line()
    emit("env", t, torch=torch.__version__, cuda=torch.version.cuda,
         device=kind, count=torch.cuda.device_count(), nvidia_smi=smi)

    # -- build ---------------------------------------------------------------
    t = time.time()
    lib_path = _build.build()
    _build.load_library()
    emit("build", t, lib=os.path.relpath(lib_path, os.path.dirname(
        os.path.abspath(__file__))))

    assets = synthesize_assets(device=dev)
    faces = assets.faces

    def posed_verts2d(b: int, wh: int, grad: bool = False):
        aa, betas, cam, _, _ = bench_scene(b)
        rot = batch_rodrigues(torch.from_numpy(aa).to(dev))
        with torch.no_grad():
            out = smpl_forward(assets, torch.from_numpy(betas).to(dev),
                               rot[:, 1:], rot[:, :1])
            tr = weak_perspective_to_translation(torch.from_numpy(cam).to(dev),
                                                 cfg.FOCAL_LENGTH, PROXY_WH)
            v2d = perspective_project(out.vertices, None, tr,
                                      focal_length=cfg.FOCAL_LENGTH,
                                      img_wh=PROXY_WH) * (wh / PROXY_WH)
        return v2d.contiguous().requires_grad_(grad)

    def band_inputs(v2d, wh):
        sigma_px = SIGMA * (wh / 2.0) ** 2
        margin = br.support_margin(sigma_px)
        tri, order, cymin, cymax, cxmin, cxmax, _ = br._sorted_tri_and_ranges(
            v2d.detach(), faces, br.CHUNK, True)
        lo, hi = br._band_chunk_bounds(cymin, cymax, -(-wh // br.BAND_H),
                                       br.BAND_H, margin)
        return (tri, cymin, cymax, cxmin, cxmax, lo, hi), sigma_px, margin

    def rel_l2(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = PARITY_SHAPES

    # -- k1_parity -----------------------------------------------------------
    t = time.time()
    rows = []
    for b, wh in shapes:
        v2d = posed_verts2d(b, wh)
        args, sigma_px, margin = band_inputs(v2d, wh)
        s_k = br.launch_fwd(*args, wh, sigma_px, margin)
        s_p = br.band_raster_fwd_plain(args[0], wh, sigma_px)
        err = float((s_k - s_p).abs().max())
        s_e = br.soft_silhouette_band(v2d, faces, wh, SIGMA, True)
        s_o = softras.soft_silhouette(v2d, softras.cull_backfaces(v2d, faces),
                                      wh, sigma=SIGMA)
        err_e = float((s_e - s_o).abs().max())
        torch.cuda.synchronize()
        check(bool(torch.isfinite(s_k).all()), "K1 output not finite")
        check(err <= K1_TOL and err_e <= K1_TOL,
              "K1 disagrees with its plain version at B=%d %d^2: %.3g / %.3g"
              % (b, wh, err, err_e))
        rows.append({"b": b, "wh": wh, "max_abs": err, "e2e_max_abs": err_e,
                     "coverage": float((s_k > 0.5).float().mean())})
    emit("k1_parity", t, tol=K1_TOL, cases=rows)

    # -- k2_parity -----------------------------------------------------------
    t = time.time()
    rows = []
    for b, wh in shapes:
        v2d = posed_verts2d(b, wh, grad=True)
        args, sigma_px, margin = band_inputs(v2d, wh)
        gw = torch.randn((b, wh, wh), generator=gen, device=dev)
        s = br.launch_fwd(*args, wh, sigma_px, margin)
        gs = (gw * (1.0 - s)).contiguous()
        d_k = br.launch_bwd(*args, gs, wh, sigma_px, margin)
        d_k2 = br.launch_bwd(*args, gs, wh, sigma_px, margin)
        d_p = br.band_raster_bwd_plain(args[0], gs, wh, sigma_px)
        err = rel_l2(d_k, d_p)
        g_e, = torch.autograd.grad(
            (br.soft_silhouette_band(v2d, faces, wh, SIGMA, True) * gw).sum(),
            v2d)
        g_o, = torch.autograd.grad(
            (softras.soft_silhouette(v2d, softras.cull_backfaces(v2d, faces),
                                     wh, sigma=SIGMA) * gw).sum(), v2d)
        err_e = rel_l2(g_e, g_o)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(d_k).all()), "K2 output not finite")
        check(err <= K2_TOL and err_e <= K2_TOL,
              "K2 disagrees with its plain version at B=%d %d^2: %.3g / %.3g"
              % (b, wh, err, err_e))
        rows.append({"b": b, "wh": wh, "rel_l2": err, "e2e_rel_l2": err_e,
                     "run_to_run_rel_l2": rel_l2(d_k2, d_k),
                     "max_abs": float((d_k - d_p).abs().max())})
    emit("k2_parity", t, tol=K2_TOL, cases=rows)

    # -- fit_parity: kernels on the card vs the plain path on the CPU --------
    t = time.time()
    b, wh = 2, 64
    aa, betas, cam, _, _ = bench_scene(b, seed=1)
    rot = batch_rodrigues(torch.from_numpy(aa))
    cpu_assets = assets.to("cpu")
    with torch.no_grad():
        out = smpl_forward(cpu_assets, torch.from_numpy(betas),
                           rot[:, 1:], rot[:, :1])
        camt = torch.from_numpy(cam)
        kp = torch.as_tensor(cfg.SMPL_TO_KPRCNN_MAP)
        j2d = undo_keypoint_normalisation(
            orthographic_project(out.joints, camt)[:, kp], wh)
        sil = (softras.render_silhouette(
            out.vertices, weak_perspective_to_translation(
                camt, cfg.FOCAL_LENGTH, wh),
            cpu_assets.faces, wh, cfg.FOCAL_LENGTH, backface_cull=True)
            > 0.5).float()
    noise = batch_rodrigues(torch.from_numpy(
        np.random.RandomState(2).randn(b, 24, 3).astype(np.float32) * 0.2))
    noisy = torch.einsum("bjxy,bjyz->bjxz", rot, noise)
    init = FitInit(noisy[:, 1:], noisy[:, :1], torch.from_numpy(betas) + 0.3,
                   camt + torch.tensor([0.05, 0.02, -0.02]))
    small_cfg = FitConfig(iters=3, proxy_wh=wh, render_wh=32,
                          faces_per_chunk=86)
    r_gpu = single_view_fit(cpu_assets, init, sil, j2d, small_cfg, device=dev)
    r_cpu = single_view_fit(cpu_assets, init, sil, j2d, small_cfg,
                            device="cpu")
    diffs = {k: float((getattr(r_gpu, k).cpu() - getattr(r_cpu, k)).abs().max())
             for k in ("body_pose", "global_orient", "betas", "cam_wp")}
    check(max(diffs.values()) <= FIT_PARAM_TOL,
          "small fit on the card disagrees with the CPU path: %s" % diffs)
    check(torch.equal(r_gpu.best_iter.cpu(), r_cpu.best_iter),
          "best_iter differs: %s vs %s" % (r_gpu.best_iter, r_cpu.best_iter))
    emit("fit_parity", t, b=b, render_wh=32, iters=3, tol=FIT_PARAM_TOL,
         max_abs=diffs, best_iter=r_gpu.best_iter.tolist(),
         iou_gpu=r_gpu.silh_iou.tolist(), iou_cpu=r_cpu.silh_iou.tolist())

    # -- fit: the main path ----------------------------------------------------
    aa, betas, cam, sil, j2d = bench_scene(FIT_BATCH)
    rot = batch_rodrigues(torch.from_numpy(aa))
    init = FitInit(rot[:, 1:], rot[:, :1], torch.from_numpy(betas),
                   torch.from_numpy(cam))
    warm = FitConfig(iters=2, render_wh=FIT_RENDER_WH)
    single_view_fit(assets, init, sil, j2d, warm, device=dev)
    torch.cuda.synchronize()
    fit_cfg = FitConfig(iters=FIT_ITERS, render_wh=FIT_RENDER_WH)
    t = time.time()
    br.reset_launch_counts()
    res = single_view_fit(assets, init, sil, j2d, fit_cfg, device=dev)
    torch.cuda.synchronize()
    dt = time.time() - t
    launches = dict(br.LAUNCHES)
    for k, n in launches.items():
        check(n == FIT_ITERS, "%s launched %d times in %d iterations"
              % (k, n, FIT_ITERS))
    shapes_ok = {"body_pose": (FIT_BATCH, 23, 3, 3),
                 "global_orient": (FIT_BATCH, 1, 3, 3),
                 "betas": (FIT_BATCH, 10), "cam_wp": (FIT_BATCH, 3),
                 "translation": (FIT_BATCH, 3), "silh_iou": (FIT_BATCH,),
                 "joint_err": (FIT_BATCH,), "init_silh_iou": (FIT_BATCH,),
                 "init_joint_err": (FIT_BATCH,), "best_iter": (FIT_BATCH,)}
    for k, shape in shapes_ok.items():
        v = getattr(res, k)
        check(tuple(v.shape) == shape, "%s has shape %s" % (k, tuple(v.shape)))
        check(v.device.type == dev.type
              and bool(torch.isfinite(v.float()).all()),
              "%s is not finite on the card" % k)
    emit("fit", t, b=FIT_BATCH, proxy_wh=PROXY_WH, render_wh=FIT_RENDER_WH,
         iters=FIT_ITERS, iters_reduced_from=cfg.SINGLE_VIEW_ITERS,
         wall_s=round(dt, 4), players_per_s=round(FIT_BATCH / dt, 3),
         init_iou=float(res.init_silh_iou.mean()),
         best_iou=float(res.silh_iou.mean()),
         init_joint_err=float(res.init_joint_err.mean()),
         best_joint_err=float(res.joint_err.mean()),
         best_iter_mean=float(res.best_iter.float().mean()),
         launches=launches)

    # -- timing: kernels at the fit's shape -------------------------------------
    t = time.time()
    v2d = posed_verts2d(FIT_BATCH, FIT_RENDER_WH)
    args, sigma_px, margin = band_inputs(v2d, FIT_RENDER_WH)
    tri, cymin, cymax, cxmin, cxmax, lo, hi = args
    s = br.launch_fwd(*args, FIT_RENDER_WH, sigma_px, margin)
    gw = torch.randn(s.shape, generator=gen, device=dev)
    gs = (gw * (1.0 - s)).contiguous()

    def time_ms(fn, reps: int, warmup: int = 2):
        """Mean ms per call over ``reps`` after ``warmup``, and the last
        call's result."""
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, out

    k_ms, k_out, plain_ms, plain_out = {}, {}, {}, {}
    k_ms["band_raster_fwd"], k_out["band_raster_fwd"] = time_ms(
        lambda: br.launch_fwd(*args, FIT_RENDER_WH, sigma_px, margin), 20)
    k_ms["band_raster_bwd"], k_out["band_raster_bwd"] = time_ms(
        lambda: br.launch_bwd(*args, gs, FIT_RENDER_WH, sigma_px, margin), 20)
    plain_ms["band_raster_fwd"], plain_out["band_raster_fwd"] = time_ms(
        lambda: br.band_raster_fwd_plain(tri, FIT_RENDER_WH, sigma_px), 1,
        warmup=1)
    plain_ms["band_raster_bwd"], plain_out["band_raster_bwd"] = time_ms(
        lambda: br.band_raster_bwd_plain(tri, gs, FIT_RENDER_WH, sigma_px), 1,
        warmup=1)
    # The kernels against their plain versions at the main path's shape.
    max_abs = {k: float((k_out[k] - plain_out[k]).abs().max()) for k in k_out}
    k2_rel = rel_l2(k_out["band_raster_bwd"], plain_out["band_raster_bwd"])
    check(all(bool(torch.isfinite(v).all()) for v in k_out.values()),
          "a kernel's output is not finite at the fit shape")
    check(max_abs["band_raster_fwd"] <= K1_TOL,
          "K1 disagrees with its plain version at the fit shape: %.3g"
          % max_abs["band_raster_fwd"])
    check(k2_rel <= K2_TOL,
          "K2 disagrees with its plain version at the fit shape: %.3g" % k2_rel)

    # (face, pixel) visits these inputs need: chunks in [lo, hi) whose padded
    # box meets the block's tile, times faces per chunk and pixels per tile.
    b, n_chunks = cymin.shape
    n_bands, n_xt = lo.shape[1], -(-FIT_RENDER_WH // br.TILE_W)
    c = torch.arange(n_chunks, device=dev)
    y0 = torch.arange(n_bands, device=dev, dtype=torch.float32) * br.BAND_H
    x0 = torch.arange(n_xt, device=dev, dtype=torch.float32) * br.TILE_W
    yhit = ((c >= lo[..., None]) & (c < hi[..., None])
            & (cymax[:, None, :].float() >= (y0 - margin)[None, :, None])
            & (cymin[:, None, :].float() <= (y0 + br.BAND_H + margin)[None, :, None]))
    xhit = ((cxmax[:, None, :].float() >= (x0 - margin)[None, :, None])
            & (cxmin[:, None, :].float() <= (x0 + br.TILE_W + margin)[None, :, None]))
    chunk_visits = int(torch.einsum("bnc,bxc->", yhit.float(), xhit.float()))
    visits = chunk_visits * br.CHUNK * br.BAND_H * br.TILE_W
    f_pad = tri.shape[1]
    in_bytes = (tri.numel() * 4 + 4 * b * n_chunks * 4 + 2 * b * n_bands * 4)
    img_bytes = b * FIT_RENDER_WH * FIT_RENDER_WH * 4
    bytes_moved = {"band_raster_fwd": in_bytes + img_bytes,
                   "band_raster_bwd": in_bytes + img_bytes + b * f_pad * 6 * 4}
    bound = {}
    for k in k_ms:
        ops_ms = visits * FLOPS_PER_VISIT[k] / PEAK_FP32_FLOPS * 1e3
        mem_ms = bytes_moved[k] / PEAK_BYTES_S * 1e3
        bound[k] = (max(ops_ms, mem_ms),
                    "operations" if ops_ms >= mem_ms else "bytes")
    # Without the band and box skip: every chunk holding a kept face.
    all_chunk_visits = int((cymin < 10 ** 8).sum()) * n_bands * n_xt
    emit("timing", t, b=FIT_BATCH, wh=FIT_RENDER_WH, band_h=br.BAND_H,
         tile_w=br.TILE_W, chunk=br.CHUNK, chunk_visits=chunk_visits,
         chunk_visits_unpruned=all_chunk_visits, visits=visits,
         k1_max_abs=max_abs["band_raster_fwd"], k2_rel_l2=k2_rel,
         k2_max_abs=max_abs["band_raster_bwd"], ms=k_ms, plain_ms=plain_ms,
         bound_ms={k: v[0] for k, v in bound.items()},
         launches_per_fit_iter={"band_raster_fwd": 1, "band_raster_bwd": 1},
         nvidia_smi=smi)

    # -- profile: where a fit iteration's time goes ---------------------------
    t = time.time()
    prof_iters = 3
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t_wall = time.time()
        single_view_fit(assets, init, sil, j2d,
                        FitConfig(iters=prof_iters, render_wh=FIT_RENDER_WH),
                        device=dev)
        torch.cuda.synchronize()
        t_wall = time.time() - t_wall
    # Device-side events only: the CPU ops that launched them report the
    # same time again.
    by_name = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    emit("profile", t, iters=prof_iters, wall_ms=round(t_wall * 1e3, 3),
         device_busy_ms=round(busy_ms, 3),
         device_idle_share=(round(1 - busy_ms / (t_wall * 1e3), 4)
                            if busy_ms else "not measured"),
         top_device_ms=[[k[:60], round(v, 3)] for k, v in top])

    kernels = []
    for name, line in (("band_raster_fwd", 33), ("band_raster_bwd", 475)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "soccerplayershapepose_torch/csrc/band_raster.cu",
            "replaces": "soccerplayershapepose_tpu/render/pallas_raster.py:%d"
                        % line,
            "launches": launches[name], "max_abs_err": max_abs[name],
            "ms": k_ms[name], "plain_ms": plain_ms[name],
            "bound_ms": bound[name][0], "bound_by": bound[name][1],
            "library_ms": None})
    check(time.time() - _T0 < BUDGET_S, "past the wall-clock budget")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
