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
  IEF, the PVE/MPJPE metrics; and ``predict_smpl`` timed at batch 128;
* the deployment-condition evaluations: ``evaluate_regressor_e2e`` (4 x 16
  domain-randomised RGB crops at 256^2, K3 at 256^2 and 64^2, ProxyNet
  ``weights/proxynet_256_f16.npz`` and the extractor, the proxy from what
  was extracted, the regressor) and ``evaluate_proxynet`` (4 x 16 crops at
  256^2, and at 512^2 on ``weights/proxynet_512_f16.npz`` while the run
  stays inside its budget), each held to its committed record;
* the full-frame path: ``evaluate_detector`` on the committed
  ``weights/detector_256x448_f16.npz`` (4 x 16 synthetic frames of 256 x
  448, 8 players each, all z-buffered in one K3 pass at 448^2 per batch),
  held to ``weights/detector_r4acct_baseline.json``; and
  ``build_frame_pipeline`` (detector, box NMS, ROI align, ProxyNet
  ``weights/proxynet_512_f16.npz`` without its IUV head, the regressor) on
  2 synthetic frames of 512 x 896 with 22 players (K3 at 896^2), timed
  warm, and held to the CPU on one frame.

Each kernel is held against its plain PyTorch version on the card and
timed at its path's shapes. Each kernel also counts the (face, pixel) pairs
it evaluates, which must equal the pairs whose pixel centre lies in a
face's padded box (K1/K2: by the support radius; K3: by 1 px); the bounds
count the pairs these inputs need. K2 and K3 must give the same bits from
run to run.
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
# The deployment-condition evaluations, as weights/regressor_18ch_e2e.json
# and weights/proxynet_{256,512}_f16.json record them (no flip TTA).
E2E_RECORD = os.path.join("weights", "regressor_18ch_e2e.json")
E2E_BATCHES, E2E_BATCH, E2E_WH = 4, 16, 256
E2E_MAX_FAILURES = 4      # of the 64 crops; the record has 0
PN_WEIGHTS = {wh: os.path.join("weights", "proxynet_%d_f16.npz" % wh)
              for wh in (256, 512)}
PN_RECORDS = {wh: os.path.join("weights", "proxynet_%d_f16.json" % wh)
              for wh in (256, 512)}
PN_BATCHES, PN_BATCH = 4, 16
PN_SHAPES = (256, 512)
PN_METRICS = ("mask_mean_iou", "kp_median_px_err", "kp_pck@0.10bbox")
# The 512² cell runs only with this much of the budget left.
PN_512_RESERVE_S = 240
# ProxyNet on the card against the same module on the CPU (fp32, TF32
# off): logits within PN_LOGIT_TOL; extracted silhouettes apart at no more
# than PN_SIL_FRAC of the pixels; joints within PN_KP_TOL px except where
# the heatmap's top two cells lie within 2 x PN_LOGIT_TOL.
PN_PARITY_B = 4
PN_LOGIT_TOL = 1e-3
PN_SIL_FRAC = 1e-3
PN_KP_TOL = 0.05
PN_TIMING_REPS = 10
# The two K3 passes of one RGB crop batch of the e2e evaluation.
K3_RGB_SHAPES = ((E2E_BATCH, E2E_WH, 1.0), (E2E_BATCH, E2E_WH // 4, 0.25))
# The detector's held-out evaluation, as weights/detector_r4acct_baseline
# .json records it (scripts/quality_record.py cell detector_hard: 4 x 16
# frames of 256 x 448, 8 players, no flip TTA, ignore below fill 0.12).
DET_WEIGHTS = os.path.join("weights", "detector_256x448_f16.npz")
DET_RECORD = os.path.join("weights", "detector_r4acct_baseline.json")
DET_BATCHES, DET_BATCH, DET_HW, DET_PLAYERS = 4, 16, (256, 448), 8
DET_METRICS = ("ap@0.5", "recall@score0.7", "precision@score0.7")
# The detector on the card against the same module on the CPU (fp32, TF32
# off): heads within DET_LOGIT_TOL; decoded scores within DET_SCORE_TOL
# (the sigmoid's slope is at most 1/4) and boxes within DET_BOX_TOL px
# (4 px x offset gap + 2 x 4 px x size gap) on slots scoring above 1e-4;
# a slot apart only at a counted near-tie.
DET_PARITY_B = 2
DET_LOGIT_TOL = 1e-3
DET_SCORE_TOL = DET_LOGIT_TOL / 4
DET_BOX_TOL = 12 * DET_LOGIT_TOL
NMS_IOU = 0.7             # decode_detections' box NMS
# The serving path at bench.py:bench_frame's shape (BENCH_FRAMES=2,
# BENCH_FRAME_ITERS=10): 512 x 896 frames, 22 players, 512^2 crops.
FRAME_HW, FRAME_PLAYERS, FRAME_B, FRAME_ITERS = (512, 896), 22, 2, 10
FRAME_SEED = 20_000_000
FRAME_CROP = 512
# Images of each K3 frame pass held against the dense plain version (which
# takes ~6 s at 448^2 for 2 images and ~35 s at 896^2 for one).
K3_FRAME_PLAIN_B = {"detector_eval": 2, "frame_pipeline": 1}
# One frame, 4 slots, on the card against the CPU, stage by stage on the
# CPU's boxes: the crops within FRAME_CROP_TOL (the same bilinear steps);
# ProxyNet's logits within PN_LOGIT_TOL, its decoded silhouette pixels and
# keypoints apart (by > PN_KP_TOL px) only at near-ties (a mask logit, or
# the heatmap's top two cells, within twice the measured logit gap),
# counted; the regressor on one set of proxies within PREDICT_TOL (the
# predict phase's bar). End to end, a valid slot whose 18-channel proxies
# (silhouette and heatmaps at 256^2) are identical holds PREDICT_TOL
# (joints in the normalised [-1, 1] crop frame); a slot whose proxy
# differs (a flipped silhouette pixel that the 2x subsampling keeps, or a
# keypoint whose truncated heatmap centre crosses a pixel) is counted and
# reported, not held to it.
FRAME_PARITY_K = 4
FRAME_CROP_TOL = 1e-5
PREDICT_TOL = 1e-3
FRAME_OUTPUTS = ("cam_wp", "betas", "pose_rotmats", "vertices", "joints2d")

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


def detection_flips(cpu, gpu, score_tol: float, box_tol: float,
                    thresh: float = 0.7) -> dict:
    """Slot-by-slot gaps between two decodes of the same frames, (F, K)
    scores and (F, K, 4) boxes as numpy, the CPU's first. Slots where both
    score at most 1e-4 are skipped. A slot whose scores differ by more
    than ``score_tol`` or boxes by more than ``box_tol`` px is a flip, and
    must be a near-tie: another peak of the frame whose score lies within
    ``score_tol`` of the slot's (the two may come in either order), or a
    box whose IoU with another lies within 1e-3 of the box NMS's
    threshold. A box apart while the scores agree is held to the same
    rule. ``valid`` (score >= ``thresh``) may differ only where a score
    lies within ``score_tol`` of it. Returns the counts by kind; raises on
    a flip that is no near-tie."""
    import numpy as np
    from soccerplayershapepose_torch.train.quality import _box_iou_matrix
    (cs, cb), (gs, gb) = cpu, gpu
    out = {"slots": 0, "score_max_abs": 0.0, "box_max_abs": 0.0,
           "order_ties": 0, "nms_ties": 0, "threshold_flips": 0}
    for f in range(cs.shape[0]):
        live = (cs[f] > 1e-4) | (gs[f] > 1e-4)
        ds = np.abs(cs[f] - gs[f])
        db = np.abs(cb[f] - gb[f]).max(-1)
        out["slots"] += int(live.sum())
        if live.any():
            out["score_max_abs"] = max(out["score_max_abs"],
                                       float(ds[live].max()))
            out["box_max_abs"] = max(out["box_max_abs"],
                                     float(db[live].max()))
        peaks = cs[f][cs[f] > 1e-4]
        for i in np.nonzero(live & ((ds > score_tol) | (db > box_tol)))[0]:
            if (np.abs(peaks - cs[f][i]) <= score_tol).sum() > 1:
                out["order_ties"] += 1
                continue
            iou = _box_iou_matrix(cb[f][i:i + 1], cb[f])[0]
            iou[i] = 0.0
            check(bool((np.abs(iou - NMS_IOU) <= 1e-3).any()),
                  "frame %d slot %d: score %.6g vs %.6g, box apart by %.3g "
                  "px, at no near-tie" % (f, i, cs[f][i], gs[f][i], db[i]))
            out["nms_ties"] += 1
        flip = (cs[f] >= thresh) != (gs[f] >= thresh)
        check(bool((np.abs(cs[f][flip] - thresh) <= score_tol).all()),
              "frame %d: valid differs away from the threshold" % f)
        out["threshold_flips"] += int(flip.sum())
    return out


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
        from soccerplayershapepose_torch.train import quality, straps, synth
        from soccerplayershapepose_torch.convert import load_proxynet_weights
        from soccerplayershapepose_torch.pipeline.extract import (
            ProxyExtractor)
        from soccerplayershapepose_torch.convert import load_detector_weights
        from soccerplayershapepose_torch.models import detector as det_mod
        from soccerplayershapepose_torch.pipeline.fullframe import (
            build_frame_pipeline)
        from soccerplayershapepose_torch.models.perception import (
            decode_keypoints, decode_silhouette)
        from soccerplayershapepose_torch.ops.roi_align import roi_align
        from soccerplayershapepose_torch.pipeline.proxy import (
            create_proxy_representation)
    except ImportError as e:
        print("chip_smoke: the port is not beside this script (%s)" % e,
              file=sys.stderr)
        return 2
    import numpy as np
    root = os.path.dirname(os.path.abspath(__file__))
    for path in (WEIGHTS, RECORD, E2E_RECORD, PN_WEIGHTS[256],
                 PN_RECORDS[256], PN_WEIGHTS[512], DET_WEIGHTS, DET_RECORD):
        if not os.path.isfile(os.path.join(root, path)):
            print("chip_smoke: %s is missing; the evaluations need the "
                  "committed weights and records" % path, file=sys.stderr)
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
    # blocks per SM of K1, K2 and K3, as the CUDA runtime reads them from
    # the loaded library.
    resources = {**br.kernel_resources(), **zb.kernel_resources()}
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

    def k3_case(scn, b, wh, scale, plain_b=None):
        """K3 at one pass shape of a scene: timed, held against its plain
        version (face ids and mask identical, barycentrics within K3_W_TOL)
        on the first ``plain_b`` images (default all b) of the same
        launch, the same bits run to run, and exactly the pairs inside the
        faces' boxes padded by 1 px evaluated."""
        plain_b = b if plain_b is None else plain_b
        v2d = (scn["verts2d"][:b] * scale).contiguous()
        z = scn["verts_z"][:b].contiguous()
        tri9, _, cymin, cymax, cxmin, cxmax, _ = zb._sorted_tri_z_and_ranges(
            v2d, z, scn["faces"])
        lo, hi = br._band_chunk_bounds(cymin, cymax, -(-wh // br.BAND_H),
                                       br.BAND_H, zb.MARGIN)
        zr = zb.face_records(tri9)
        args = (zr, lo, hi, wh)
        ms, out = time_ms(lambda: zb.launch_zbuffer(*args), 20)
        p_ms, ref = time_ms(lambda: zb.rasterize_bary_plain(
            tri9[:plain_b], wh), 1, warmup=0)
        again = zb.launch_zbuffer(*args)
        n_eval = pairs_evaluated(lambda n: zb.launch_zbuffer(
            *args, pair_count=n))
        head = [o[:plain_b] for o in out]
        same = bool(torch.equal(head[0], ref[0]))
        w_err = max(float((head[i] - ref[i]).abs().max()) for i in (1, 2))
        check(same and w_err <= K3_W_TOL,
              "K3 disagrees with its plain version at the path's shape B=%d "
              "%d^2: ids %s, w %.3g" % (plain_b, wh, same, w_err))
        check(all(torch.equal(x, y) for x, y in zip(out, again)),
              "K3 differs from run to run at B=%d %d^2" % (b, wh))
        padded = br.support_pairs(zr[..., zb.BOX], wh)
        check(n_eval == padded, "K3 evaluated %d pairs, the padded boxes "
              "hold %d at B=%d %d^2" % (n_eval, padded, b, wh))
        n_cv, n_cv_all = chunk_visits(cymin, cymax, cxmin, cxmax, lo, hi,
                                      wh, br.BAND_H, br.TILE_W, zb.MARGIN)
        visits_chunk_level = n_cv * br.CHUNK * br.BAND_H * br.TILE_W
        # The work these inputs need: the pixel centres inside each face's
        # own box (a pixel outside it cannot be covered), no margin.
        k3_support = br.support_pairs(br.face_boxes(tri9[..., :6], 0.0), wh)
        n_chunks, n_bands = cymin.shape[1], lo.shape[1]
        # The chunks the kernel can reach: those inside some band's [lo, hi)
        # (the faces of a dropped player, +1e5 px away, lie in none).
        ci = torch.arange(n_chunks, device=lo.device)
        reach = ((ci >= lo[..., None]) & (ci < hi[..., None])).any(1)
        n_reach = int(reach.sum())
        # Each input read once (the reachable chunks' faces, 9 floats each,
        # and their four box entries; lo and hi), each output written once
        # (face id, w0, w1: 12 bytes per pixel).
        bytes_moved = (n_reach * (br.CHUNK * 9 + 4) * 4
                       + 2 * b * n_bands * 4 + b * wh * wh * 12)
        bound_ms, bound_by = roofline_ms(k3_support * K3_FLOPS_PER_PAIR,
                                         bytes_moved)
        return {"b": b, "wh": wh, "faces": int(scn["faces"].shape[0]),
                "ms": ms, "plain_b": plain_b, "plain_ms": p_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_ms_chunk_level": roofline_ms(
                    visits_chunk_level * K3_FLOPS_PER_PAIR, bytes_moved)[0],
                "support_pairs": k3_support, "pairs_evaluated": n_eval,
                "faces_reachable": n_reach * br.CHUNK,
                "padded_box_pairs": padded,
                # The gather: every x-tile of a band tests each face of the
                # band's [lo, hi).
                "faces_scanned": int((hi - lo).clamp(min=0).sum())
                * br.CHUNK * -(-wh // zb.TILE_W),
                "chunk_visits": n_cv,
                "visits_chunk_level": visits_chunk_level,
                "chunk_visits_unpruned": n_cv_all, "w_max_abs": w_err,
                "w_bit_equal": all(torch.equal(head[i], ref[i])
                                   for i in (1, 2)),
                "coverage": float((out[0] >= 0).float().mean())}

    # -- k3_timing: K3 at the evaluation's two pass shapes ---------------------
    t = time.time()
    k3 = [dict(k3_case(scene, b, wh, scale), path="synth_eval")
          for b, wh, scale in K3_SHAPES]
    # A NaN vertex and an absent occluder (+1e5 px): K3 neither hangs nor
    # disagrees with its plain version.
    v2d, z = k3_scene(2, 0.25)
    absent = scene["verts2d"][:2, -1, 0] > 1e4
    v2d = v2d.clone()
    v2d[:, 100, 0] = float("nan")
    tri9, _, cymin, cymax, _, _, _ = zb._sorted_tri_z_and_ranges(
        v2d, z, scene["faces"])
    wh = EVAL_WH // 4
    lo, hi = br._band_chunk_bounds(cymin, cymax, -(-wh // br.BAND_H),
                                   br.BAND_H, zb.MARGIN)
    zr = zb.face_records(tri9)
    n_eval = pairs_evaluated(lambda n: zb.launch_zbuffer(
        zr, lo, hi, wh, pair_count=n))
    out = zb.launch_zbuffer(zr, lo, hi, wh)
    ref = zb.rasterize_bary_plain(tri9, wh)
    torch.cuda.synchronize()
    check(bool(absent.any()), "no absent occluder in the NaN-vertex case")
    check(all(torch.equal(a, c) for a, c in zip(out, ref)),
          "K3 disagrees with its plain version on the NaN-vertex case")
    check(n_eval == br.support_pairs(zr[..., zb.BOX], wh),
          "K3 evaluated %d pairs on the NaN-vertex case" % n_eval)
    edge_case = {"b": 2, "wh": wh, "absent_occluders": int(absent.sum()),
                 "nan_faces": int(torch.isnan(tri9[..., :6]).any(-1).sum()),
                 "pairs_evaluated": n_eval, "bit_equal": True}
    emit("k3_timing", t, flops_per_pair=K3_FLOPS_PER_PAIR, shapes=k3,
         nan_vertex_case=edge_case, launches_per_eval_batch=len(K3_SHAPES),
         resources=resources["zbuffer_bary"], nvidia_smi=smi)

    # -- eval_profile: where an evaluation's time goes -------------------------
    t = time.time()
    emit("eval_profile", t, **device_profile(
        lambda: straps.evaluate_regressor(
            model, assets, n_batches=EVAL_BATCHES, batch=EVAL_BATCH,
            wh=EVAL_WH, seed=EVAL_SEED, device=dev)))

    # == The deployment-condition evaluations: RGB crops, ProxyNet, K3 ========
    with open(os.path.join(root, E2E_RECORD)) as f:
        e2e_record = json.load(f)
    pn_nets = {256: load_proxynet_weights(os.path.join(root, PN_WEIGHTS[256]),
                                          dev)}
    # The first batch of the e2e evaluation: geometry from the CPU stream of
    # evaluate_regressor, appearance from a generator on the card.
    e2e_draws = synth.sample_crop_draws(
        torch.Generator().manual_seed(EVAL_SEED), E2E_BATCH,
        image_wh=E2E_WH,
        image_gen=torch.Generator(device=dev).manual_seed(EVAL_SEED))
    rgb = synth.render_crop_batch(assets, e2e_draws, E2E_WH, with_image=True)
    images = straps.crop_images_u8(rgb["image"])
    check(tuple(images.shape) == (E2E_BATCH, E2E_WH, E2E_WH, 3)
          and bool(torch.isfinite(rgb["image"]).all()),
          "the RGB crops are not (B, wh, wh, 3) finite values")

    # -- proxynet_parity: ProxyNet on the card vs the same module on the CPU --
    t = time.time()
    pn_cpu = load_proxynet_weights(os.path.join(root, PN_WEIGHTS[256]), "cpu")
    x = images[:PN_PARITY_B].permute(0, 3, 1, 2).float() / 255.0
    with torch.no_grad():
        out_gpu = pn_nets[256](x)
        out_cpu = pn_cpu(x.cpu())
    head_err = {name: float((g.cpu() - c).abs().max())
                for name, g, c in zip(out_gpu._fields, out_gpu, out_cpu)}
    check(max(head_err.values()) <= PN_LOGIT_TOL,
          "ProxyNet on the card disagrees with the CPU: %s" % head_err)
    ex_gpu = ProxyExtractor(pn_nets[256], wh=E2E_WH, device=dev)
    ex_cpu = ProxyExtractor(pn_cpu, wh=E2E_WH, device="cpu")
    maps_gpu = ex_gpu.forward(images[:PN_PARITY_B])
    r_gpu = ex_gpu.pick(*maps_gpu)
    r_cpu = ex_cpu(images[:PN_PARITY_B].cpu())
    fails = [r[0] is None for r in r_gpu]
    check(fails == [r[0] is None for r in r_cpu],
          "extraction failures differ, card %s vs CPU %s"
          % (fails, [r[0] is None for r in r_cpu]))
    kp_logits = maps_gpu[0].cpu()
    top2 = torch.topk(kp_logits.flatten(1, 2), 2, dim=1).values
    kp_ties = (top2[:, 0] - top2[:, 1]) < 2 * PN_LOGIT_TOL        # (B, 17)
    sil_apart, kp_apart, n_ties = [], [], int(kp_ties.sum())
    for i, (g, c) in enumerate(zip(r_gpu, r_cpu)):
        if g[0] is None:
            continue
        sil_apart.append(float(np.mean(g[1] != c[1])))
        far = np.abs(g[0][:, :2] - c[0][:, :2]).max(-1) > PN_KP_TOL
        kp_apart.append(int(far.sum()))
        check(not (far & ~kp_ties[i].numpy()).any(),
              "crop %d: joints %s apart by more than %g px on no near-tie"
              % (i, np.nonzero(far)[0].tolist(), PN_KP_TOL))
    check(all(f <= PN_SIL_FRAC for f in sil_apart),
          "extracted silhouettes differ at %s of their pixels" % sil_apart)
    emit("proxynet_parity", t, b=PN_PARITY_B, wh=E2E_WH,
         logit_tol=PN_LOGIT_TOL, head_max_abs=head_err, failures=fails,
         sil_apart_frac=sil_apart, kp_tol_px=PN_KP_TOL,
         joints_apart=kp_apart, kp_near_ties=n_ties)

    # -- proxynet_timing: the forward and the host extraction per batch -------
    t = time.time()
    timing = {}
    for wh in PN_SHAPES:
        imgs = images if wh == E2E_WH else images.repeat_interleave(
            wh // E2E_WH, 1).repeat_interleave(wh // E2E_WH, 2)
        xf = imgs.permute(0, 3, 1, 2).float() / 255.0
        for flip in (False, True):
            ex = ProxyExtractor(pn_nets[256], wh=wh, flip_tta=flip,
                                device=dev)
            with torch.no_grad():
                net_ms, _ = time_ms(
                    lambda: pn_nets[256](torch.cat([xf, xf.flip(3)])
                                         if flip else xf), PN_TIMING_REPS)
            fwd_ms, maps = time_ms(lambda: ex.forward(imgs), PN_TIMING_REPS)
            t_host = time.perf_counter()
            for _ in range(3):
                ex.pick(*maps)
            host_ms = (time.perf_counter() - t_host) / 3 * 1e3
            timing["%d%s" % (wh, "_flip" if flip else "")] = {
                "net_ms": net_ms, "extractor_forward_ms": fwd_ms,
                "host_pick_ms": host_ms}
    emit("proxynet_timing", t, b=E2E_BATCH, reps=PN_TIMING_REPS,
         note="512^2 crops are the 256^2 crops upsampled 2x (nearest)",
         per_batch=timing, nvidia_smi=smi)

    # -- k3_rgb_parity: K3 at the RGB crops' two pass shapes -------------------
    t = time.time()
    rgb_scene = synth.crop_scene(assets, synth.draws_to(e2e_draws, dev),
                                 E2E_WH)
    k3_rgb = [dict(k3_case(rgb_scene, b, wh, scale), path="e2e_eval")
              for b, wh, scale in K3_RGB_SHAPES]
    emit("k3_rgb_parity", t, flops_per_pair=K3_FLOPS_PER_PAIR, shapes=k3_rgb,
         nvidia_smi=smi)
    k3 += k3_rgb

    # -- e2e_eval: RGB crop -> extractor -> regressor, the new main path ------
    t = time.time()
    ex = ProxyExtractor(pn_nets[256], wh=E2E_WH, device=dev)

    def e2e(**kw):
        return straps.evaluate_regressor_e2e(
            model, ex, assets, n_batches=E2E_BATCHES, batch=E2E_BATCH,
            wh=E2E_WH, seed=EVAL_SEED, device=dev, **kw)

    e2e_cold = e2e()
    torch.cuda.synchronize()
    cold_s = time.time() - t
    t_e2e = time.time()
    zb.reset_launch_counts()
    res_e2e = e2e()
    torch.cuda.synchronize()
    e2e_s = time.time() - t_e2e
    k3_launches_e2e = zb.LAUNCHES["zbuffer_bary"]
    check(k3_launches_e2e == 2 * E2E_BATCHES,
          "K3 launched %d times in %d e2e batches"
          % (k3_launches_e2e, E2E_BATCHES))
    n_total = res_e2e["n_images"] + res_e2e["extraction_failures"]
    check(n_total == E2E_BATCHES * E2E_BATCH
          and res_e2e["extraction_failures"] <= E2E_MAX_FAILURES,
          "e2e: %d failures of %d crops" % (res_e2e["extraction_failures"],
                                            n_total))
    check(all(np.isfinite(res_e2e[k]) for k in metrics),
          "e2e metrics missing or not finite: %s" % res_e2e)
    for k in ("mpjpe_pa_mm", "pve_pa_mm"):
        check(abs(res_e2e[k] - e2e_record[k]) <= RECORD_REL * e2e_record[k],
              "e2e %s %.2f is not within %d%% of the record %.2f"
              % (k, res_e2e[k], RECORD_REL * 100, e2e_record[k]))
    stage_s = {}
    e2e(stage_times=stage_s)
    emit("e2e_eval", t, n_images=res_e2e["n_images"],
         extraction_failures=res_e2e["extraction_failures"], wh=E2E_WH,
         flip_tta=False, wall_s=round(e2e_s, 4),
         images_per_s=round(n_total / e2e_s, 2),
         cold_wall_s=round(cold_s, 4), k3_launches=k3_launches_e2e,
         repeat_max_rel=max(abs(res_e2e[k] - e2e_cold[k])
                            / max(abs(e2e_cold[k]), 1e-12) for k in metrics),
         stage_s_synchronised={k: round(v, 4) for k, v in stage_s.items()},
         metrics={k: res_e2e[k] for k in metrics},
         record={k: e2e_record[k] for k in metrics},
         record_rel_tol=RECORD_REL, nvidia_smi=smi)

    # -- e2e_profile: where an e2e evaluation's time goes ----------------------
    t = time.time()
    emit("e2e_profile", t, **device_profile(e2e))

    # == The full-frame path: frame synthesis (K3), detector, pipeline =======
    det_gpu = load_detector_weights(os.path.join(root, DET_WEIGHTS), dev)
    det_cpu = load_detector_weights(os.path.join(root, DET_WEIGHTS), "cpu")
    with open(os.path.join(root, DET_RECORD)) as f:
        det_record = json.load(f)
    # The first batch of the detector's evaluation: geometry from a CPU
    # generator, appearance from one on the card, seeded as
    # evaluate_detector seeds its batch 0.
    det_seed = quality.EVAL_SEED_BASE + 500_000
    det_draws = synth.sample_frame_draws(
        torch.Generator().manual_seed(det_seed), DET_BATCH, DET_PLAYERS,
        DET_HW, image_gen=torch.Generator(device=dev).manual_seed(det_seed))
    det_scene = synth.frame_scene(assets, det_draws, DET_HW)
    # The pipeline's frames: 2 of 512 x 896, 22 players each, made ahead of
    # the timed window; K3 runs once for the batch.
    frame_draws = synth.sample_frame_draws(
        torch.Generator().manual_seed(FRAME_SEED), FRAME_B, FRAME_PLAYERS,
        FRAME_HW,
        image_gen=torch.Generator(device=dev).manual_seed(FRAME_SEED))
    frame_scene = synth.frame_scene(assets, frame_draws, FRAME_HW)

    # -- k3_frame_parity: K3 at the frames' 448^2 and 896^2 passes -----------
    # The dense plain version takes seconds here, so it runs on the first
    # images of the timed launch only: 2 of the evaluation's 16 frames at
    # 448^2 (110,208 faces each), 1 of the pipeline's 2 at 896^2 (303,072).
    t = time.time()
    k3_frames = [
        dict(k3_case(scn, b, scn["wh"], 1.0, K3_FRAME_PLAIN_B[path]),
             path=path)
        for path, scn, b in (("detector_eval", det_scene, DET_BATCH),
                             ("frame_pipeline", frame_scene, FRAME_B))]
    for r, scn in zip(k3_frames, (det_scene, frame_scene)):
        r["dropped_players"] = int((scn["boxes"][:r["b"], :, 0] > 1e4).sum())
        check(r["dropped_players"] > 0, "no dropped player at %d^2" % r["wh"])
    emit("k3_frame_parity", t, flops_per_pair=K3_FLOPS_PER_PAIR,
         shapes=k3_frames, launches_per_path_pass=1, nvidia_smi=smi)
    k3 += k3_frames

    # -- detector_parity: the detector on the card vs the CPU ---------------
    t = time.time()
    zb.reset_launch_counts()
    det_frames = synth.render_frame_batch(assets, det_draws,
                                          DET_HW)["image"]
    check(zb.LAUNCHES["zbuffer_bary"] == 1,
          "K3 launched %d times for one frame batch"
          % zb.LAUNCHES["zbuffer_bary"])
    check(tuple(det_frames.shape) == (DET_BATCH,) + DET_HW + (3,)
          and bool(torch.isfinite(det_frames).all()),
          "the frames are not (B, h, w, 3) finite values")
    x = det_frames[:DET_PARITY_B].permute(0, 3, 1, 2)
    with torch.no_grad():
        heads_gpu = det_gpu(x)
        heads_cpu = det_cpu(x.cpu())
    head_err = {name: float((g.cpu() - c).abs().max())
                for name, g, c in zip(heads_gpu._fields, heads_gpu,
                                      heads_cpu)}
    check(max(head_err.values()) <= DET_LOGIT_TOL,
          "the detector on the card disagrees with the CPU: %s" % head_err)

    def as_np(d):
        return d.scores.cpu().numpy(), d.boxes.cpu().numpy()

    det_gaps = detection_flips(
        as_np(det_mod.decode_detections(heads_cpu)),
        as_np(det_mod.decode_detections(heads_gpu)), DET_SCORE_TOL,
        DET_BOX_TOL)
    emit("detector_parity", t, b=DET_PARITY_B, hw=list(DET_HW),
         logit_tol=DET_LOGIT_TOL, head_max_abs=head_err,
         score_tol=DET_SCORE_TOL, box_tol_px=DET_BOX_TOL, decode=det_gaps)

    # -- detector_eval: held-out AP on the card (K3 once per batch) ---------
    t = time.time()

    def det_eval():
        return quality.evaluate_detector(
            det_gpu, assets, n_batches=DET_BATCHES, batch=DET_BATCH,
            hw=DET_HW, n_players=DET_PLAYERS, device=dev)

    det_cold = det_eval()
    torch.cuda.synchronize()
    cold_s = time.time() - t
    t_det = time.time()
    zb.reset_launch_counts()
    res_det = det_eval()
    torch.cuda.synchronize()
    det_s = time.time() - t_det
    k3_launches_det = zb.LAUNCHES["zbuffer_bary"]
    check(k3_launches_det == DET_BATCHES,
          "K3 launched %d times in %d detector batches"
          % (k3_launches_det, DET_BATCHES))
    for k in DET_METRICS:
        check(abs(res_det[k] - det_record[k]) <= RECORD_REL * det_record[k],
              "detector %s %.4f is not within %d%% of the record %.4f"
              % (k, res_det[k], RECORD_REL * 100, det_record[k]))
    # The detector's forward and its decode alone, at the evaluation's
    # batch.
    with torch.no_grad():
        fwd_ms, heads = time_ms(lambda: det_gpu(det_frames.permute(0, 3, 1,
                                                                    2)), 10)
    dec_ms, _ = time_ms(lambda: det_mod.decode_detections(heads), 10)
    n_frames = DET_BATCHES * DET_BATCH
    emit("detector_eval", t, n_images=n_frames, hw=list(DET_HW),
         detector_forward_ms=fwd_ms, decode_ms=dec_ms,
         players=DET_PLAYERS, flip_tta=False, wall_s=round(det_s, 4),
         images_per_s=round(n_frames / det_s, 2),
         cold_wall_s=round(cold_s, 4), k3_launches=k3_launches_det,
         repeat_equal=all(res_det[k] == det_cold[k] for k in DET_METRICS),
         metrics=res_det, record={k: det_record[k] for k in DET_METRICS},
         record_rel_tol=RECORD_REL, profile=device_profile(det_eval),
         nvidia_smi=smi)

    # -- frame_pipeline: frames -> detections -> crops -> meshes ------------
    t = time.time()
    pn_frame = load_proxynet_weights(os.path.join(root, PN_WEIGHTS[512]), dev,
                                     with_iuv=False)
    zb.reset_launch_counts()
    frames = synth.render_frame_batch(assets, frame_draws,
                                      FRAME_HW)["image"].contiguous()
    torch.cuda.synchronize()
    k3_launches_frame = zb.LAUNCHES["zbuffer_bary"]
    check(k3_launches_frame == 1, "K3 launched %d times for the pipeline's "
          "frames" % k3_launches_frame)
    fn = build_frame_pipeline(det_gpu, pn_frame, model,
                              max_players=FRAME_PLAYERS, crop_wh=FRAME_CROP,
                              device=dev)
    out = fn(assets, frames)                                   # warm
    torch.cuda.synchronize()
    t_fr = time.time()
    for _ in range(FRAME_ITERS):
        out = fn(assets, frames)
    torch.cuda.synchronize()
    frame_s = (time.time() - t_fr) / FRAME_ITERS
    k = FRAME_PLAYERS
    shapes_ok = {"vertices": (FRAME_B, k, 6890, 3),
                 "joints2d": (FRAME_B, k, 17, 2),
                 "pose_rotmats": (FRAME_B, k, 24, 3, 3),
                 "betas": (FRAME_B, k, 10), "cam_wp": (FRAME_B, k, 3),
                 "boxes": (FRAME_B, k, 4), "scores": (FRAME_B, k),
                 "valid": (FRAME_B, k)}
    for name, shape in shapes_ok.items():
        v = getattr(out, name)
        check(tuple(v.shape) == shape and v.device.type == dev.type
              and bool(torch.isfinite(v.float()).all()),
              "frame pipeline: %s is %s, not finite %s on the card"
              % (name, tuple(v.shape), shape))
    stage_s = {}
    fn_staged = build_frame_pipeline(det_gpu, pn_frame, model,
                                     max_players=FRAME_PLAYERS,
                                     crop_wh=FRAME_CROP, device=dev,
                                     stage_times=stage_s)
    for _ in range(3):
        fn_staged(assets, frames)
    # One frame with 4 slots through the card and through the CPU.
    fn4 = build_frame_pipeline(det_gpu, pn_frame, model,
                               max_players=FRAME_PARITY_K,
                               crop_wh=FRAME_CROP, device=dev)
    pn_cpu512 = load_proxynet_weights(os.path.join(root, PN_WEIGHTS[512]),
                                      "cpu", with_iuv=False)
    reg_cpu = load_regressor_weights(os.path.join(root, WEIGHTS), "cpu")
    cpu_assets = assets.to("cpu")
    fn4_cpu = build_frame_pipeline(det_cpu, pn_cpu512, reg_cpu,
                                   max_players=FRAME_PARITY_K,
                                   crop_wh=FRAME_CROP, device="cpu")
    frame1 = frames[:1].cpu()
    o_gpu = fn4(assets, frames[:1])
    o_cpu = fn4_cpu(cpu_assets, frame1)
    frame_gaps = detection_flips(
        (o_cpu.scores.numpy(), o_cpu.boxes.numpy()),
        (o_gpu.scores.cpu().numpy(), o_gpu.boxes.cpu().numpy()),
        DET_SCORE_TOL, DET_BOX_TOL)
    # Stage by stage on the CPU's square boxes.
    c = FRAME_CROP
    sq = o_cpu.boxes
    crops_c = roi_align(frame1, sq, c, sampling_ratio=1).reshape(-1, c, c, 3)
    crops_g = roi_align(frames[:1], sq.to(dev), c,
                        sampling_ratio=1).reshape(-1, c, c, 3)
    crop_err = float((crops_g.cpu() - crops_c).abs().max())
    check(crop_err <= FRAME_CROP_TOL,
          "the crops on the card differ from the CPU's by %.3g" % crop_err)
    with torch.no_grad():
        p_c = pn_cpu512(crops_c.permute(0, 3, 1, 2))
        p_g = pn_frame(crops_c.to(dev).permute(0, 3, 1, 2))
    gap = {n: float((getattr(p_g, n).cpu() - getattr(p_c, n)).abs().max())
           for n in ("kp_logits", "mask_logits")}
    check(max(gap.values()) <= PN_LOGIT_TOL,
          "ProxyNet at 512^2 on the card disagrees with the CPU: %s" % gap)
    sil_c = decode_silhouette(p_c.mask_logits)
    sil_g = decode_silhouette(p_g.mask_logits).cpu()
    sil_flip = sil_c != sil_g                                  # (K, c, c)
    check(bool((p_c.mask_logits[sil_flip].abs()
                <= 2 * gap["mask_logits"]).all()),
          "a silhouette pixel flips away from a mask logit near 0")
    stride = c // p_c.kp_logits.shape[1]
    kp_c = decode_keypoints(p_c.kp_logits, stride)
    kp_g = decode_keypoints(p_g.kp_logits, stride).cpu()
    top2 = torch.topk(p_c.kp_logits.flatten(1, 2), 2, dim=1).values
    kp_ties = (top2[:, 0] - top2[:, 1]) <= 2 * gap["kp_logits"]   # (K, 17)
    kp_far = (kp_g[..., :2] - kp_c[..., :2]).abs().amax(-1) > PN_KP_TOL
    check(not bool((kp_far & ~kp_ties).any()),
          "joints %s apart by more than %g px at no near-tie"
          % (torch.nonzero(kp_far & ~kp_ties).tolist(), PN_KP_TOL))
    r_g = predict_smpl(model, assets, sil_c.to(dev), kp_c.to(dev),
                       proxy_wh=c, device=dev)
    r_c = predict_smpl(reg_cpu, cpu_assets, sil_c, kp_c, proxy_wh=c,
                       device="cpu")
    norm = {"joints2d_kprcnn": c / 2.0}
    reg_err = {n: float((getattr(r_g, n).cpu() - getattr(r_c, n)).abs().max())
               / norm.get(n, 1.0) for n in r_c._fields}
    check(max(reg_err.values()) <= PREDICT_TOL,
          "the regressor on the card disagrees with the CPU: %s" % reg_err)
    # The regressor's inputs: a silhouette flip on a sampled pixel, or a
    # keypoint whose truncated heatmap centre moves, changes the proxy.
    prox_c = create_proxy_representation(sil_c, kp_c, in_wh=c)
    prox_g = create_proxy_representation(sil_g, kp_g, in_wh=c)
    proxy_px = (prox_c != prox_g).flatten(1).sum(1)            # (K,)
    # End to end: the slots that hold the same valid detection on both
    # sides; those whose proxies agree are held to PREDICT_TOL.
    same = (o_cpu.valid & o_gpu.valid.cpu()
            & ((o_cpu.boxes - o_gpu.boxes.cpu()).abs().amax(-1)
               <= DET_BOX_TOL))[0]
    flipped = proxy_px > 0                                     # (K,)
    check(bool(same.any()), "no valid slot to compare on the parity frame")
    out_err, out_err_flipped = {}, {}
    for name in FRAME_OUTPUTS:
        d = (getattr(o_gpu, name).cpu() - getattr(o_cpu, name))[0]
        d = d.abs().flatten(1).amax(1) / (c / 2.0 if name == "joints2d"
                                          else 1.0)           # (K,)
        held, other = d[same & ~flipped], d[same & flipped]
        out_err[name] = float(held.max()) if len(held) else 0.0
        out_err_flipped[name] = float(other.max()) if len(other) else 0.0
        check(out_err[name] <= PREDICT_TOL,
              "frame pipeline on the card disagrees with the CPU on a slot "
              "with the same proxies: %s %.3g" % (name, out_err[name]))
    frame_parity = {
        "max_players": FRAME_PARITY_K, "decode": frame_gaps,
        "crop_max_abs": crop_err, "proxynet_logit_max_abs": gap,
        "sil_flip_px": sil_flip.flatten(1).sum(1).tolist(),
        "kp_apart": kp_far.sum(1).tolist(),
        "kp_near_ties": int(kp_ties.sum()),
        "proxy_values_apart": proxy_px.tolist(),
        "regressor_max_abs": reg_err,
        "valid_slots_compared": int(same.sum()),
        "slots_with_proxy_flips": int((same & flipped).sum()),
        "out_max_abs_same_proxies": out_err,
        "out_max_abs_flipped_proxies": out_err_flipped,
        "tol": PREDICT_TOL}
    emit("frame_pipeline", t, frames=FRAME_B, hw=list(FRAME_HW),
         max_players=FRAME_PLAYERS, crop_wh=FRAME_CROP, iters=FRAME_ITERS,
         weights=[DET_WEIGHTS, PN_WEIGHTS[512] + " (no IUV head)", WEIGHTS],
         precision="fp32, TF32 off",
         ms_per_call=round(frame_s * 1e3, 3),
         frames_per_s=round(FRAME_B / frame_s, 3),
         crops_per_s=round(FRAME_B * FRAME_PLAYERS / frame_s, 2),
         valid_slots=int(out.valid.sum()),
         stage_ms_synchronised={n: round(v / 3 * 1e3, 3)
                                for n, v in stage_s.items()},
         k3_launches_frame_synthesis=k3_launches_frame,
         parity=frame_parity,
         profile=device_profile(lambda: fn(assets, frames)),
         nvidia_smi=smi)

    # -- proxynet_eval: ProxyNet's held-out quality at 256² (and 512²) ------
    k3_launches_pn = {}
    for wh in PN_SHAPES:
        t = time.time()
        if wh != E2E_WH and time.time() - _T0 > BUDGET_S - PN_512_RESERVE_S:
            emit("proxynet_eval", t, wh=wh, skipped="less than %d s of the "
                 "%d s budget left" % (PN_512_RESERVE_S, BUDGET_S))
            continue
        if wh not in pn_nets:
            pn_nets[wh] = load_proxynet_weights(
                os.path.join(root, PN_WEIGHTS[wh]), dev)
        with open(os.path.join(root, PN_RECORDS[wh])) as f:
            pn_record = json.load(f)
        ex = ProxyExtractor(pn_nets[wh], wh=wh, device=dev)

        def pn_eval():
            return quality.evaluate_proxynet(ex, assets, n_batches=PN_BATCHES,
                                             batch=PN_BATCH, wh=wh)

        pn_cold = pn_eval()
        torch.cuda.synchronize()
        t_pn = time.time()
        zb.reset_launch_counts()
        res_pn = pn_eval()
        torch.cuda.synchronize()
        pn_s = time.time() - t_pn
        k3_launches_pn[wh] = zb.LAUNCHES["zbuffer_bary"]
        check(k3_launches_pn[wh] == 2 * PN_BATCHES,
              "K3 launched %d times in %d proxynet batches at %d^2"
              % (k3_launches_pn[wh], PN_BATCHES, wh))
        check(res_pn["n_images"] == PN_BATCHES * PN_BATCH,
              "proxynet eval saw %d images" % res_pn["n_images"])
        for k in PN_METRICS:
            check(abs(res_pn[k] - pn_record[k]) <= RECORD_REL * pn_record[k],
                  "proxynet %d^2 %s %.4f is not within %d%% of the record "
                  "%.4f" % (wh, k, res_pn[k], RECORD_REL * 100,
                            pn_record[k]))
        emit("proxynet_eval", t, wh=wh, weights=PN_WEIGHTS[wh],
             n_images=res_pn["n_images"],
             extraction_failures=res_pn["extraction_failures"],
             wall_s=round(pn_s, 4),
             images_per_s=round(res_pn["n_images"] / pn_s, 2),
             k3_launches=k3_launches_pn[wh],
             repeat_max_rel=max(abs(res_pn[k] - pn_cold[k])
                                / max(abs(pn_cold[k]), 1e-12)
                                for k in PN_METRICS),
             metrics={k: v for k, v in res_pn.items()
                      if isinstance(v, float)},
             record={k: pn_record[k] for k in PN_METRICS},
             record_rel_tol=RECORD_REL, nvidia_smi=smi)

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
    # K3 runs once at each pass shape per batch, on six paths: the
    # synthetic evaluation and ProxyNet's at 512² (512² and 128² passes),
    # the e2e evaluation and ProxyNet's at 256² (256² and 64²), the
    # detector's evaluation (one 448² pass per batch of 16 frames) and the
    # frame pipeline's synthesis (one 896² pass for its 2 frames). Its
    # times are the mean per launch over the six pass shapes, its pairs the
    # sum over them; "shapes" gives each (the plain version's time on
    # plain_b of the b images), "launches_by_path" each path's count.
    k3_by_path = {"synth_eval": k3_launches, "e2e_eval": k3_launches_e2e,
                  "detector_eval": k3_launches_det,
                  "frame_pipeline_synthesis": k3_launches_frame}
    k3_by_path.update({"proxynet_eval_%d" % wh: n
                       for wh, n in k3_launches_pn.items()})
    kernels.append({
        "name": "zbuffer_bary", "route": "cuda",
        "source": "soccerplayershapepose_torch/csrc/zbuffer.cu",
        "replaces": "soccerplayershapepose_tpu/render/pallas_zbuffer.py:42",
        "launches": sum(k3_by_path.values()),
        "launches_by_path": k3_by_path,
        "max_abs_err": max(r["w_max_abs"] for r in k3),
        "ms": sum(r["ms"] for r in k3) / len(k3),
        "plain_ms": sum(r["plain_ms"] for r in k3) / len(k3),
        "bound_ms": sum(r["bound_ms"] for r in k3) / len(k3),
        "bound_by": "operations" if all(r["bound_by"] == "operations"
                                        for r in k3) else "bytes",
        "library_ms": None,
        "support_pairs": sum(r["support_pairs"] for r in k3),
        "pairs_evaluated": sum(r["pairs_evaluated"] for r in k3),
        "shapes": [{k: r[k] for k in ("path", "b", "wh", "faces", "ms",
                                      "plain_b", "plain_ms", "bound_ms",
                                      "support_pairs", "pairs_evaluated",
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
