#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card and check its kernels.

    python3 chip_smoke.py

Builds the kernels from ``soccerplayershapepose_torch/csrc`` with one nvcc
call and drives the port's two paths on the card:

* the single-view fit of the 22-player bench scene (512^2 targets, 256^2
  render, the full synthetic SMPL mesh, random init from seed 0), which
  runs the band rasterizer K1/K2;
* the held-out synthetic evaluation of the committed 18-channel regressor
  (``weights/regressor_18ch_f16.npz``): 4 batches of 16 crops at 512^2,
  two SMPL bodies per crop, two z-buffer passes (K3) per batch, ResNet-18 +
  IEF, the PVE/MPJPE metrics; and ``predict_smpl`` timed at batch 128.

Each kernel is held against its plain PyTorch version on the card and
timed at its path's shapes. K1 and K2 also count the (face, pixel) pairs
they evaluate, which must equal the pairs whose pixel centre lies in a
face's box padded by the support radius; the bounds count those pairs.
Prints one JSON line per phase, then the card's ``nvidia-smi`` name and
power limit, a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when CUDA is absent, the package is not
beside this script or the committed weights are missing; exits non-zero
when any check fails or the run passes its wall-clock budget. Imports
nothing of JAX.
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
# (batch, render size, sigma): the fit's sigma, and the self-supervised
# trainer's 1e-4, whose faces' supports are 3.2x wider.
PARITY_CASES = ((2, 128, 1e-5), (1, 256, 1e-5), (1, 256, 1e-4),
                (1, 512, 1e-4))
FIT_ITERS = 20            # the stage runs 100; cut so the run stays short
FIT_BATCH = 22
FIT_RENDER_WH = 256
PROXY_WH = 512
SIGMA = 1e-5
K1_TOL = 1e-6             # max abs, fp32 sums in another order
K2_TOL = 1e-5             # relative L2, fp32 sums in another order
FIT_PARAM_TOL = 1e-4      # a tenth of one Adam step at lr 1e-3
# fp32 operations per (face, pixel) pair, counted from the kernel bodies;
# the header of csrc/band_raster.cu breaks the two counts down.
FLOPS_PER_PAIR = {"band_raster_fwd": 73, "band_raster_bwd": 93}
PEAK_FP32_FLOPS = 67e12   # H100 SXM, outside the tensor cores
PEAK_BYTES_S = 3.35e12    # H100 SXM HBM3
# The synthetic evaluation, as weights/regressor_18ch_f16.json records it.
WEIGHTS = os.path.join("weights", "regressor_18ch_f16.npz")
RECORD = os.path.join("weights", "regressor_18ch_f16.json")
EVAL_BATCHES, EVAL_BATCH, EVAL_WH = 4, 16, 512
EVAL_SEED = 10_000_000
RECORD_REL = 0.25         # PA metrics vs the record: another random stream
EVAL_PLAIN_B = 4          # batch of the kernel-vs-plain evaluation
EVAL_PLAIN_REL = 1e-4     # its metrics, kernel route vs plain route
PREDICT_BATCH = 128
PREDICT_REPS = 10
K3_W_TOL = 1e-6           # max abs: the same fp32 steps, no contraction
K3_ATTR_TOL = 1e-5        # max abs: sorted vs original face order
# Where the kernel route and the dense oracle pick different faces, the
# depths they chose may differ by at most this many ulps: a tie that the
# kernel's z = w0·z0 + w1·z1 + (1 − w0 − w1)·z2 and the oracle's w2 = e2/area
# break apart. Read through the depth channel, the two depths of one face
# differ by at most 3 ulps over the 68,044 covered pixels of the 128² pass
# (CPU, plain versions); a face missed by the pruning would differ by
# thousands.
K3_TIE_ULPS = 8
K3_FLOPS_PER_PAIR = 36    # broken down in the header of csrc/zbuffer.cu
# The two K3 passes of one evaluation batch: (batch, size, vertex scale).
K3_SHAPES = ((EVAL_BATCH, EVAL_WH, 1.0), (EVAL_BATCH, EVAL_WH // 4, 0.25))
# The kernel route against the dense oracle: the 128² pass at full batch,
# the 512² pass at B=4 to keep the oracle's run short.
K3_PARITY_SHAPES = ((EVAL_BATCH, EVAL_WH // 4, 0.25),
                    (EVAL_PLAIN_B, EVAL_WH, 1.0))

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


def chunk_visits(cymin, cymax, cxmin, cxmax, lo, hi, img_wh, band_h,
                 tile_w, margin):
    """(chunk visits, chunk visits without the band and box skip) of a
    banded kernel on these inputs: chunks in a band's [lo, hi) whose box,
    padded by ``margin``, meets the block's tile; unpruned, every chunk
    holding a face for every block."""
    import torch
    dev = cymin.device
    n_chunks = cymin.shape[1]
    n_bands, n_xt = lo.shape[1], -(-img_wh // tile_w)
    c = torch.arange(n_chunks, device=dev)
    y0 = torch.arange(n_bands, device=dev, dtype=torch.float32) * band_h
    x0 = torch.arange(n_xt, device=dev, dtype=torch.float32) * tile_w
    yhit = ((c >= lo[..., None]) & (c < hi[..., None])
            & (cymax[:, None, :].float() >= (y0 - margin)[None, :, None])
            & (cymin[:, None, :].float()
               <= (y0 + band_h + margin)[None, :, None]))
    xhit = ((cxmax[:, None, :].float() >= (x0 - margin)[None, :, None])
            & (cxmin[:, None, :].float()
               <= (x0 + tile_w + margin)[None, :, None]))
    visits = int(torch.einsum("bnc,bxc->", yhit.float(), xhit.float()))
    return visits, int((cymin < 10 ** 8).sum()) * n_bands * n_xt


def roofline_ms(ops: float, bytes_moved: float):
    """(the least time the card could take, in ms, and what bounds it):
    fp32 operations over the fp32 peak or bytes over the memory rate,
    whichever is larger."""
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    mem_ms = bytes_moved / PEAK_BYTES_S * 1e3
    return max(ops_ms, mem_ms), "operations" if ops_ms >= mem_ms else "bytes"


def device_profile(fn) -> dict:
    """Run ``fn`` once under ``torch.profiler``: wall ms, device-busy ms,
    the device's idle share and the top device consumers. Device-side
    events only: the CPU ops that launched them report the same time
    again."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t_wall = time.time()
        fn()
        torch.cuda.synchronize()
        t_wall = time.time() - t_wall
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
    return {"wall_ms": round(t_wall * 1e3, 3),
            "device_busy_ms": round(busy_ms, 3),
            "device_idle_share": (round(1 - busy_ms / (t_wall * 1e3), 4)
                                  if busy_ms else "not measured"),
            "top_device_ms": [[k[:60], round(v, 3)] for k, v in top]}


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
        from soccerplayershapepose_torch.convert import load_regressor_weights
        from soccerplayershapepose_torch.pipeline import predict_smpl
        from soccerplayershapepose_torch.render import attribute
        from soccerplayershapepose_torch.render import zbuffer as zb
        from soccerplayershapepose_torch.train import straps, synth
    except ImportError as e:
        print("chip_smoke: the port is not beside this script (%s)" % e,
              file=sys.stderr)
        return 2
    import numpy as np
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isfile(os.path.join(root, WEIGHTS)):
        print("chip_smoke: %s is missing; the evaluation needs the committed "
              "regressor weights" % WEIGHTS, file=sys.stderr)
        return 2

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
    # Registers, static shared memory, local (spill) bytes and resident
    # blocks per SM of K1 and K2, as the CUDA runtime reads them from the
    # loaded library.
    resources = br.kernel_resources()
    emit("build", t, lib=os.path.relpath(lib_path, os.path.dirname(
        os.path.abspath(__file__))), resources=resources)

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

    def band_inputs(v2d, wh, sigma=SIGMA):
        sigma_px = sigma * (wh / 2.0) ** 2
        args, _ = br.band_inputs(v2d.detach(), faces, wh, sigma_px, True)
        return args, sigma_px, br.support_margin(sigma_px)

    def rel_l2(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))

    def pairs_evaluated(launch):
        """The (face, pixel) pairs one counting launch of a kernel
        evaluates."""
        n = torch.zeros(1, dtype=torch.int64, device=dev)
        launch(n)
        return int(n)

    gen = torch.Generator(device=dev).manual_seed(0)

    # -- k1_parity -----------------------------------------------------------
    # Each kernel also evaluates exactly the pairs whose pixel centre lies
    # in the face's padded box: its own count equals support_pairs.
    t = time.time()
    rows = []
    for b, wh, sigma in PARITY_CASES:
        v2d = posed_verts2d(b, wh)
        args, sigma_px, margin = band_inputs(v2d, wh, sigma)
        s_k = br.launch_fwd(*args, wh, sigma_px, margin)
        s_p = br.band_raster_fwd_plain(args[0], wh, sigma_px)
        err = float((s_k - s_p).abs().max())
        s_e = br.soft_silhouette_band(v2d, faces, wh, sigma, True)
        s_o = softras.soft_silhouette(v2d, softras.cull_backfaces(v2d, faces),
                                      wh, sigma=sigma)
        err_e = float((s_e - s_o).abs().max())
        n_eval = pairs_evaluated(lambda n: br.launch_fwd(
            *args, wh, sigma_px, margin, pair_count=n))
        n_support = br.support_pairs(args[0][..., br.BOX], wh)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(s_k).all()), "K1 output not finite")
        check(err <= K1_TOL and err_e <= K1_TOL,
              "K1 disagrees with its plain version at B=%d %d^2 sigma %g: "
              "%.3g / %.3g" % (b, wh, sigma, err, err_e))
        check(n_eval == n_support, "K1 evaluated %d pairs, the padded boxes "
              "hold %d" % (n_eval, n_support))
        rows.append({"b": b, "wh": wh, "sigma": sigma, "max_abs": err,
                     "e2e_max_abs": err_e, "pairs_evaluated": n_eval,
                     "support_pairs": n_support,
                     "coverage": float((s_k > 0.5).float().mean())})
    emit("k1_parity", t, tol=K1_TOL, cases=rows)

    # -- k2_parity -----------------------------------------------------------
    t = time.time()
    rows = []
    for b, wh, sigma in PARITY_CASES:
        v2d = posed_verts2d(b, wh, grad=True)
        args, sigma_px, margin = band_inputs(v2d, wh, sigma)
        fc = args[0]
        gw = torch.randn((b, wh, wh), generator=gen, device=dev)
        s = br.launch_fwd(*args, wh, sigma_px, margin)
        gs = (gw * (1.0 - s)).contiguous()
        d_k = br.launch_bwd(fc, gs, wh, sigma_px)
        d_k2 = br.launch_bwd(fc, gs, wh, sigma_px)
        d_p = br.band_raster_bwd_plain(fc, gs, wh, sigma_px)
        err = rel_l2(d_k, d_p)
        g_e, = torch.autograd.grad(
            (br.soft_silhouette_band(v2d, faces, wh, sigma, True) * gw).sum(),
            v2d)
        g_o, = torch.autograd.grad(
            (softras.soft_silhouette(v2d, softras.cull_backfaces(v2d, faces),
                                     wh, sigma=sigma) * gw).sum(), v2d)
        err_e = rel_l2(g_e, g_o)
        n_eval = pairs_evaluated(lambda n: br.launch_bwd(
            fc, gs, wh, sigma_px, pair_count=n))
        n_support = br.support_pairs(fc[..., br.BOX], wh)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(d_k).all()), "K2 output not finite")
        check(err <= K2_TOL and err_e <= K2_TOL,
              "K2 disagrees with its plain version at B=%d %d^2 sigma %g: "
              "%.3g / %.3g" % (b, wh, sigma, err, err_e))
        # No atomics: two launches on the same inputs agree bit for bit.
        check(torch.equal(d_k, d_k2), "K2 differs from run to run")
        check(n_eval == n_support, "K2 evaluated %d pairs, the padded boxes "
              "hold %d" % (n_eval, n_support))
        rows.append({"b": b, "wh": wh, "sigma": sigma, "rel_l2": err,
                     "e2e_rel_l2": err_e,
                     "run_to_run_rel_l2": rel_l2(d_k2, d_k),
                     "max_abs": float((d_k - d_p).abs().max()),
                     "pairs_evaluated": n_eval, "support_pairs": n_support})
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
    fc, cymin, cymax, cxmin, cxmax, lo, hi = args
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

    launch = {
        "band_raster_fwd": lambda n=None: br.launch_fwd(
            *args, FIT_RENDER_WH, sigma_px, margin, pair_count=n),
        "band_raster_bwd": lambda n=None: br.launch_bwd(
            fc, gs, FIT_RENDER_WH, sigma_px, pair_count=n)}
    plain = {
        "band_raster_fwd": lambda: br.band_raster_fwd_plain(
            fc, FIT_RENDER_WH, sigma_px),
        "band_raster_bwd": lambda: br.band_raster_bwd_plain(
            fc, gs, FIT_RENDER_WH, sigma_px)}
    k_ms, k_out, plain_ms, plain_out, evaluated = {}, {}, {}, {}, {}
    for k in launch:
        k_ms[k], k_out[k] = time_ms(launch[k], 20)
        plain_ms[k], plain_out[k] = time_ms(plain[k], 1, warmup=1)
        evaluated[k] = pairs_evaluated(launch[k])
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

    # The work these inputs need: the pairs whose pixel centre lies in a
    # live face's box padded by the support radius, whatever the design.
    # The chunk-level count (every face of a chunk that meets an 8 x 32
    # tile, at all its pixels: the work of the first port's kernels) is
    # kept beside it as history.
    support = br.support_pairs(fc[..., br.BOX], FIT_RENDER_WH)
    check(all(n == support for n in evaluated.values()),
          "the kernels evaluated %s pairs, the padded boxes hold %d"
          % (evaluated, support))
    b, n_chunks = cymin.shape
    n_bands = lo.shape[1]
    n_cv, all_chunk_visits = chunk_visits(
        cymin, cymax, cxmin, cxmax, lo, hi, FIT_RENDER_WH, br.BAND_H,
        br.TILE_W, margin)
    visits_chunk_level = n_cv * br.CHUNK * br.BAND_H * br.TILE_W
    # K1's gather: every x-tile of a band tests each face of the band's
    # [lo, hi) once.
    k1_faces_scanned = int((hi - lo).clamp(min=0).sum()) * br.CHUNK * (
        -(-FIT_RENDER_WH // br.TILE_W))
    f_pad = fc.shape[1]
    # Each input read once: the triangles (24 bytes a face; the 80-byte
    # records are derived from them), the chunk boxes and band bounds for
    # K1, g(1 - S) for K2; each output written once.
    tri_bytes = b * f_pad * 6 * 4
    img_bytes = b * FIT_RENDER_WH * FIT_RENDER_WH * 4
    bytes_moved = {
        "band_raster_fwd": (tri_bytes + 4 * b * n_chunks * 4
                            + 2 * b * n_bands * 4 + img_bytes),
        "band_raster_bwd": 2 * tri_bytes + img_bytes}
    bound = {k: roofline_ms(support * FLOPS_PER_PAIR[k], bytes_moved[k])
             for k in k_ms}
    bound_chunk_level = {
        k: roofline_ms(visits_chunk_level * FLOPS_PER_PAIR[k],
                       bytes_moved[k])[0] for k in k_ms}
    emit("timing", t, b=FIT_BATCH, wh=FIT_RENDER_WH, sigma=SIGMA,
         band_h=br.BAND_H, tile_w=br.TILE_W, chunk=br.CHUNK,
         support_radius_px=br.support_radius(sigma_px),
         support_pairs=support, pairs_evaluated=evaluated,
         chunk_visits=n_cv, chunk_visits_unpruned=all_chunk_visits,
         visits_chunk_level=visits_chunk_level,
         k1_faces_scanned=k1_faces_scanned,
         k1_max_abs=max_abs["band_raster_fwd"], k2_rel_l2=k2_rel,
         k2_max_abs=max_abs["band_raster_bwd"], ms=k_ms, plain_ms=plain_ms,
         bound_ms={k: v[0] for k, v in bound.items()},
         bound_by={k: v[1] for k, v in bound.items()},
         bound_ms_chunk_level=bound_chunk_level, bytes_moved=bytes_moved,
         launches_per_fit_iter={"band_raster_fwd": 1, "band_raster_bwd": 1},
         resources=resources, nvidia_smi=smi)

    # -- profile: where a fit iteration's time goes ---------------------------
    t = time.time()
    prof_iters = 3
    emit("profile", t, iters=prof_iters, **device_profile(
        lambda: single_view_fit(
            assets, init, sil, j2d,
            FitConfig(iters=prof_iters, render_wh=FIT_RENDER_WH),
            device=dev)))

    # == The synthetic evaluation: predict half and K3 ==========================
    model = load_regressor_weights(os.path.join(root, WEIGHTS), dev)
    with open(os.path.join(root, RECORD)) as f:
        record = json.load(f)
    gen_cpu = torch.Generator().manual_seed(EVAL_SEED)
    draws = synth.sample_crop_draws(gen_cpu, EVAL_BATCH)
    scene = synth.crop_scene(assets, synth.draws_to(draws, dev), EVAL_WH)
    pass_attrs = synth.pass_attributes(assets, scene["is_player"])

    def k3_scene(b, scale):
        return ((scene["verts2d"][:b] * scale).contiguous(),
                scene["verts_z"][:b].contiguous())

    def ulp(x):
        return torch.nextafter(x, torch.full_like(x, float("inf"))) - x

    # -- k3_parity: the kernel route against the dense oracle ------------------
    # K3 itself meets its plain version at the path's two shapes in
    # k3_timing. Here the route (K3, then the gather) meets the oracle over
    # the faces in their original order. The depth rides along as a last
    # attribute channel, so that wherever the two take different faces the
    # depth each one chose is read: those pixels must be depth ties within
    # K3_TIE_ULPS, and every other pixel agrees within K3_ATTR_TOL.
    t = time.time()
    rows = []
    for b, wh, scale in K3_PARITY_SHAPES:
        v2d, z = k3_scene(b, scale)
        attrs = pass_attrs[0 if wh == EVAL_WH else 1][:b]
        az = torch.cat([attrs, z[..., None]], dim=-1)
        a_k, m_k = attribute.rasterize_attributes(v2d, z, az, scene["faces"],
                                                  wh)
        a_p, m_p = attribute.rasterize_attributes_plain(v2d, z, az,
                                                        scene["faces"], wh)
        per_px = (a_k[..., :-1] - a_p[..., :-1]).abs().amax(-1)
        apart = per_px > K3_ATTR_TOL
        z_k, z_p = a_k[..., -1][apart], a_p[..., -1][apart]
        gap_ulps = (z_k - z_p).abs() / ulp(torch.maximum(z_k.abs(),
                                                         z_p.abs()))
        n_apart = int(apart.sum())
        torch.cuda.synchronize()
        check(bool(torch.equal(m_k, m_p)),
              "the kernel route's mask differs from the oracle's at B=%d %d^2"
              % (b, wh))
        check(bool((gap_ulps <= K3_TIE_ULPS).all()),
              "the kernel route and the oracle take faces of different depth "
              "at B=%d %d^2: gaps %s ulps" % (b, wh, gap_ulps.tolist()))
        rows.append({"b": b, "wh": wh, "attrs": attrs.shape[-1],
                     "covered_px": int(m_k.sum()), "px_apart": n_apart,
                     "apart_z_route": z_k.tolist(),
                     "apart_z_oracle": z_p.tolist(),
                     "apart_gap_ulps": gap_ulps.tolist(),
                     "apart_max_abs": (float(per_px[apart].max())
                                       if n_apart else 0.0),
                     "max_abs_elsewhere": float(per_px[~apart].max()),
                     "coverage": float(m_k.float().mean())})
    emit("k3_parity", t, attr_tol=K3_ATTR_TOL, tie_ulps=K3_TIE_ULPS,
         cases=rows)

    # -- predict: crop -> mesh at batch 128, warm ------------------------------
    t = time.time()
    crops = synth.crop_labels(assets, scene["verts2d"], scene["verts_z"],
                              scene["faces"], scene["is_player"],
                              scene["joints2d"], EVAL_WH)
    reps = -(-PREDICT_BATCH // EVAL_BATCH)
    sil = crops["silhouette"].repeat(reps, 1, 1)[:PREDICT_BATCH]
    j2d = crops["joints2d"].repeat(reps, 1, 1)[:PREDICT_BATCH]
    pred = predict_smpl(model, assets, sil, j2d, device=dev)
    torch.cuda.synchronize()
    t_pred = time.time()
    for _ in range(PREDICT_REPS):
        pred = predict_smpl(model, assets, sil, j2d, device=dev)
    torch.cuda.synchronize()
    pred_ms = (time.time() - t_pred) / PREDICT_REPS * 1e3
    for k, v in pred._asdict().items():
        check(v.shape[0] == PREDICT_BATCH and v.device.type == dev.type
              and bool(torch.isfinite(v).all()), "predict: %s not finite" % k)
    # The card against the CPU path on two crops.
    small = predict_smpl(model, assets, sil[:2], j2d[:2], device=dev)
    ref = predict_smpl(model.to("cpu"), assets.to("cpu"), sil[:2].cpu(),
                       j2d[:2].cpu(), device="cpu")
    model.to(dev)
    pred_err = {k: float((getattr(small, k).cpu() - getattr(ref, k)).abs()
                         .max()) for k in small._fields}
    pred_err["joints2d_kprcnn"] /= cfg.PROXY_REP_INPUT_WH / 2.0
    check(max(pred_err.values()) <= 1e-3,
          "predict on the card disagrees with the CPU path: %s" % pred_err)
    emit("predict", t, b=PREDICT_BATCH, ms_per_batch=round(pred_ms, 3),
         crops_per_s=round(PREDICT_BATCH / pred_ms * 1e3, 1),
         card_vs_cpu_max_abs=pred_err, nvidia_smi=smi)

    # -- synth_eval: the main path of K3 ---------------------------------------
    t = time.time()
    res_cold = straps.evaluate_regressor(
        model, assets, n_batches=EVAL_BATCHES, batch=EVAL_BATCH, wh=EVAL_WH,
        seed=EVAL_SEED, device=dev)
    torch.cuda.synchronize()
    cold_s = time.time() - t
    t_eval = time.time()
    zb.reset_launch_counts()
    res = straps.evaluate_regressor(
        model, assets, n_batches=EVAL_BATCHES, batch=EVAL_BATCH, wh=EVAL_WH,
        seed=EVAL_SEED, device=dev)
    torch.cuda.synchronize()
    eval_s = time.time() - t_eval
    k3_launches = zb.LAUNCHES["zbuffer_bary"]
    check(k3_launches == 2 * EVAL_BATCHES,
          "K3 launched %d times in %d batches" % (k3_launches, EVAL_BATCHES))
    metrics = [k for k in record if k.endswith(("_mm", "_px"))]
    check(len(metrics) == 9 and all(np.isfinite(res[k]) for k in metrics),
          "evaluation metrics missing or not finite: %s" % res)
    for k in ("mpjpe_pa_mm", "pve_pa_mm"):
        check(abs(res[k] - record[k]) <= RECORD_REL * record[k],
              "%s %.2f is not within %d%% of the record %.2f"
              % (k, res[k], RECORD_REL * 100, record[k]))
    # One small batch through the kernel route and through the plain
    # versions on the card, with the same draws. On CUDA tensors the wrapper
    # always launches K3, so the plain versions are swapped in here, for
    # this comparison only.
    d4 = [straps.RegressorDraws(synth.sample_crop_draws(
        torch.Generator().manual_seed(EVAL_SEED + 1), EVAL_PLAIN_B), None)]
    m_kernel = straps.evaluate_regressor(model, assets, wh=EVAL_WH,
                                         draws=d4, device=dev)
    synth.rasterize_attributes = attribute.rasterize_attributes_plain
    try:
        m_plain = straps.evaluate_regressor(model, assets, wh=EVAL_WH,
                                            draws=d4, device=dev)
    finally:
        synth.rasterize_attributes = attribute.rasterize_attributes
    plain_rel = {k: abs(m_kernel[k] - m_plain[k]) / max(abs(m_plain[k]),
                                                        1e-12)
                 for k in metrics}
    check(max(plain_rel.values()) <= EVAL_PLAIN_REL,
          "the evaluation through K3 disagrees with the plain route: %s"
          % plain_rel)
    emit("synth_eval", t, n_images=res["n_images"], wh=EVAL_WH,
         wall_s=round(eval_s, 4), images_per_s=round(res["n_images"] / eval_s,
                                                     2),
         cold_wall_s=round(cold_s, 4), k3_launches=k3_launches,
         repeat_max_rel=max(abs(res[k] - res_cold[k]) / abs(res_cold[k])
                            for k in metrics),
         metrics={k: res[k] for k in metrics},
         record={k: record[k] for k in metrics}, record_rel_tol=RECORD_REL,
         kernel_vs_plain_b=EVAL_PLAIN_B, kernel_vs_plain_rel=plain_rel,
         nvidia_smi=smi)

    # -- k3_timing: K3 at the evaluation's two pass shapes ---------------------
    t = time.time()
    k3 = []
    for b, wh, scale in K3_SHAPES:
        v2d, z = k3_scene(b, scale)
        tri9, _, cymin, cymax, cxmin, cxmax, _ = zb._sorted_tri_z_and_ranges(
            v2d, z, scene["faces"])
        lo, hi = br._band_chunk_bounds(cymin, cymax, -(-wh // br.BAND_H),
                                       br.BAND_H, zb.MARGIN)
        args = (tri9, cymin, cymax, cxmin, cxmax, lo, hi)
        ms, out = time_ms(lambda: zb.launch_zbuffer(*args, wh), 20)
        p_ms, ref = time_ms(lambda: zb.rasterize_bary_plain(tri9, wh), 1,
                            warmup=0)
        # The kernel against its plain version: face ids and mask
        # identical, barycentrics within K3_W_TOL.
        same = bool(torch.equal(out[0], ref[0]))
        w_err = max(float((out[i] - ref[i]).abs().max()) for i in (1, 2))
        check(same and w_err <= K3_W_TOL,
              "K3 disagrees with its plain version at the path's shape B=%d "
              "%d^2: ids %s, w %.3g" % (b, wh, same, w_err))
        n_cv, n_cv_all = chunk_visits(cymin, cymax, cxmin, cxmax, lo, hi,
                                      wh, br.BAND_H, br.TILE_W, zb.MARGIN)
        visits_chunk_level = n_cv * br.CHUNK * br.BAND_H * br.TILE_W
        # The work these inputs need: the pixel centres inside each face's
        # own box (a pixel outside it cannot be covered), no margin. The
        # kernel itself still walks the chunk-level visits.
        k3_support = br.support_pairs(br.face_boxes(tri9[..., :6], 0.0),
                                      wh)
        n_chunks, n_bands = cymin.shape[1], lo.shape[1]
        # Each input read once (the table, four box arrays, lo and hi), each
        # output written once (face id, w0, w1: 12 bytes per pixel).
        bytes_moved = (tri9.numel() * 4 + 4 * b * n_chunks * 4
                       + 2 * b * n_bands * 4 + b * wh * wh * 12)
        bound_ms, bound_by = roofline_ms(k3_support * K3_FLOPS_PER_PAIR,
                                         bytes_moved)
        k3.append({"b": b, "wh": wh, "ms": ms, "plain_ms": p_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_ms_chunk_level": roofline_ms(
                       visits_chunk_level * K3_FLOPS_PER_PAIR,
                       bytes_moved)[0],
                   "support_pairs": k3_support, "chunk_visits": n_cv,
                   "visits_chunk_level": visits_chunk_level,
                   "chunk_visits_unpruned": n_cv_all, "w_max_abs": w_err,
                   "coverage": float((out[0] >= 0).float().mean())})
    emit("k3_timing", t, flops_per_pair=K3_FLOPS_PER_PAIR, shapes=k3,
         launches_per_eval_batch=len(K3_SHAPES), nvidia_smi=smi)

    # -- eval_profile: where an evaluation's time goes -------------------------
    t = time.time()
    emit("eval_profile", t, **device_profile(
        lambda: straps.evaluate_regressor(
            model, assets, n_batches=EVAL_BATCHES, batch=EVAL_BATCH,
            wh=EVAL_WH, seed=EVAL_SEED, device=dev)))

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
            "library_ms": None, "support_pairs": support,
            "pairs_evaluated": evaluated[name],
            "bound_ms_chunk_level": bound_chunk_level[name]})
    # K3 runs once at each pass shape per batch: its times are the mean per
    # launch over one batch's two launches; "shapes" gives each.
    kernels.append({
        "name": "zbuffer_bary", "route": "cuda",
        "source": "soccerplayershapepose_torch/csrc/zbuffer.cu",
        "replaces": "soccerplayershapepose_tpu/render/pallas_zbuffer.py:42",
        "launches": k3_launches,
        "max_abs_err": max(r["w_max_abs"] for r in k3),
        "ms": sum(r["ms"] for r in k3) / len(k3),
        "plain_ms": sum(r["plain_ms"] for r in k3) / len(k3),
        "bound_ms": sum(r["bound_ms"] for r in k3) / len(k3),
        "bound_by": "operations" if all(r["bound_by"] == "operations"
                                        for r in k3) else "bytes",
        "library_ms": None,
        "shapes": [{k: r[k] for k in ("b", "wh", "ms", "plain_ms",
                                      "bound_ms", "support_pairs",
                                      "bound_ms_chunk_level")} for r in k3]})
    check(time.time() - _T0 < BUDGET_S, "past the wall-clock budget")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
