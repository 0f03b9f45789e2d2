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
  warm, and held to the CPU on one frame;
* the remaining fit stages and the GT-3D fit evaluations, each held to
  its committed record: ``evaluate_fit_3d`` (8 x 8 crops at 512^2, the
  100-iteration single-view fit), ``evaluate_fit_3d_multiview`` (2 x 8
  players x 3 views from the scene factory, K3 once per 512^2 view; the
  single-view arm and 3 rounds of the multi-view alternation, K1/K2 on
  24 rows) and ``evaluate_fit_3d_track`` (2 x 4 players x 8 frames, one
  K3 pass per batch, the shared-betas track fit on 32 rows);
  ``broad_view_fit`` on one scene's broadcast view from its multi-view
  result; and ``track_fit`` at bench.py:bench_track's 44 rows, timed warm;
* the folder-tree stages: a tree of 4 scenes x 6 players x 3 views and the
  broad view at 512^2 from the scene factory (K3) and the tree writer;
  the single-view, multi-view and broadcast-view stages and the metric
  roll-ups on it, at the JAX package's mint configuration, held to
  ``weights/distill_r05/mint_summary.json``; the single-view stage at its
  own defaults (32 rows, 512^2 render: K1/K2 at a new shape) with its
  mesh overlays on 8 views; ``create_proxy_stage`` (ProxyNet at 512^2 with flip TTA)
  on one RGB scene and ``predict_stage`` on what it wrote; and the
  command line's multi-view and broadcast-view fits
  (``python -m soccerplayershapepose_torch``) as subprocesses on a
  1-scene tree;
* texture extraction and the attribute renders: the texture probe
  (``texture/quality.py``, the counterpart of ``scripts/texture_probe.py``:
  4 x 16 RGB crops at 256^2, ProxyNet ``weights/proxynet_256_f16.npz``
  with its IUV head, atlases from the ground-truth and the predicted IUV
  at the 64^2 grid), held to ``weights/texture_quality.json``; the
  part-segmentation and textured renders of 2 crops at 512^2 (a player
  and its occluder each; the texture is the probe's fused predicted
  atlas) through K3, held to the plain route; the committed regressor
  expanded to 21 and 20 input channels, its 512^2 evaluation held to the
  18-channel one, and the e2e evaluation with ProxyNet's IUV; the
  relation module v0 and v1 (``weights/relation_v{0,1}.npz``) on 64 x 8
  synthetic scenes of 6 players, held to ``weights/relation_v{0,1}
  _eval.json`` and, on one batch, to the CPU;
* the one-clip rehearsal (``scripts/e2e_rehearsal.py``, held to
  ``weights/e2e_r05/summary.json``): a synthetic mp4v clip of 16 wide
  256 x 448 frames with 8 players (K3 at 448^2) and 6 RGB close-ups (K3
  at 256^2 and 64^2), taken through the command line as subprocesses
  (harvest-frames with the frame classifier
  ``weights/frame_classifier.npz``, crop-broad-player, create-proxy,
  predict, single-view, calc-metrics); the classifier on the card held to
  the CPU and timed per frame; the detect and crop stages in process,
  timed and split; and the single-view stage at its defaults on the
  clip's crops (K1/K2 at 32 rows x 512^2);
* after those, the trainers, on the folder tree above: the distillation
  trainer (``drivers/training.py:train_regressor`` on the tree's
  broadcast proxies and broadcast-view pseudo-GT, warm-started from the
  committed regressor, 3 epochs and a resumed 4th, its first step held to
  the CPU, its fp16 weights reloaded); the self-supervised trainer
  (``train/selfsup.py``, item 'both') on 8 of the tree's views: 10 steps
  through K1 forward and K2 backward at 512^2 and sigma 1e-4, one step
  held to the plain route on 2 rows, the kernels timed at that shape;
  ``evaluate_model`` and ``evaluate_model_relate`` (v0, v1, and v1 with
  the camera re-fit): each arm's metrics held to
  ``weights/relate_eval_v{0,1}.json`` within 5.84 standard errors of the
  tree's per-scene spread (Student's t, 3 degrees of freedom, 0.995), the relation module's effect (with / without)
  within 25% of the records', one scene held to the CPU; the relation
  trainer (v0, the record's settings, the first 300 steps of its
  3000-step schedule, the first 3 held to the CPU); and the command
  line's ``train`` and ``train --resume`` as subprocesses;
* then perception training and the baselines: ProxyNet's trainer
  (``train/perception.py``, 8 crops of 256^2 with an occluder each: K3 at
  256^2 and 64^2 inside every step) for 20 steps from flax's initialisers
  (the loss must fall; the first step on the card held to the CPU's), and
  warm from ``weights/proxynet_256_f16.npz`` for 4 steps at lr 1e-5, saved
  f16-packed, reloaded and evaluated at its record's setting (64 crops of
  256^2, +-25% of ``weights/proxynet_256_f16.json``); the detector's (4
  frames of 256 x 448 with 6 players: K3 at 448^2, B = 4) for 12 steps
  and warm from ``weights/detector_256x448_f16.npz``, evaluated as
  ``detector_eval`` is; the frame classifier's head
  (``train_classifier``) on the committed feature net's features of 64
  ``build_dataset`` frames, its first epoch held to the CPU's; real-proxy
  batches (``train/real_data.py``) from the create-proxy scene mixed with
  synthetic ones, each real batch equal to the CPU loader's; one
  extracted batch (16 crops of 256^2 through ProxyNet and the extractor)
  and a distillation step on it; the baseline evaluations
  (``drivers/baselines.py``) of the committed regressor's predictions on
  the mint tree's first scene, written as HMR ``.npy`` and SPIN ``.npz``
  files: single-view, cross-view and multi-view fits at their defaults and
  512^2 (K1/K2 at the players' and the views' rows), the IoU rising and
  the joint error falling, one player held to the CPU; and the command
  line's ``train-perception`` for both nets as subprocesses;
* then the training drivers (``scripts/train_perception_torch.py``) in
  this process: ``drive-regressor`` at the r05 fine-tune's settings
  (``scripts/tpu_queue_r5.sh``: 16 crops of 256^2, lr 3e-5, warm from the
  committed regressor, extracted batches through ProxyNet 256 into a keyed
  cache) cut from 1500 steps to 6 in segments of 3, evaluated after each
  segment on 1 batch; the same run as two ``regressor`` segments (return
  codes 10 and 0), whose ``state.npz`` and ``weights_last.npz`` must equal
  the drive's bit for bit (deterministic algorithms on); ``eval-regressor``
  of ``weights/regressor_r05/weights_last.npz``, clean at 512^2 and
  through ProxyNet at 256^2 (4 x 16 crops each), held to that folder's
  ``clean_eval.json`` and ``e2e_eval.json``; ``drive-proxynet`` for 4
  steps of 8 crops at 256^2 with two evaluations;
  ``scripts/train_relation_torch.py`` (20 steps of v0 at its defaults, and
  ``relate`` on the mint tree); K3 at the regressor's synthetic batch
  (256^2 and 64^2, B = 16);
* last, the data- and model-parallel layer (``parallel/``) at the default
  single-view stage's batch (32 rows, 512^2, 20 iterations with the mint
  chain's priors, deterministic algorithms on): the sharded fit over NCCL
  at world size 1 in this process (one card) bit for bit against the plain
  loop, ms an iteration of each; then two gloo ranks on cuda:0 (started
  after the build, so that they reach the card and run their work once
  while the parity phases run, and waiting until this phase) holding the
  sharded fit (16 rows a rank) to the one-process card fit after 3
  iterations at the CPU tests' bars, each rank's K1/K2 launches counted,
  ProxyNet's ``shard_train_step`` on the 8 crops of 256^2 split 4 + 4 (its
  batch synthesised by K3 here) to the one-process step, and the
  distillation step on a (1, 2) grid (the IEF's large fc layers
  column-parallel) to the unsplit step; K1/K2 per launch at the rank's
  16 x 512^2 from the profiler.

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

import argparse
import contextlib
import copy
import dataclasses
import faulthandler
import gc
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from collections import Counter

# The wall-clock budget. With the regressor's trainers the checks took 659
# s on one host of the card and 882 s before their last phase on another
# (the host-bound phases move 40-60% from host to host); with the
# perception trainers and the baselines (about 75 s more) 779-825 s on
# hosts like the first. 1080 s keeps a slow host's run inside it and
# leaves the 1200 s a run may take room for the start-up.
BUDGET_S = 1080
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
# The GT-3D fit evaluations, as their committed records ran them
# (scripts/train_perception.py:_fit3d_cfg with the records' "fit_knobs"):
# 2 batches at 512^2, the fits rendered at 256^2 (FIT_RENDER_WH); the
# single-view benchmark on 8 crops a batch, the multi-view one on 8
# players x 3 views (3 rounds of 50 + 50 iterations, and a 100-iteration
# single-view arm on view 0), the track one on 4 players x 8 frames. The
# single-view benchmark runs 8 batches here: its batches' init MPJPE-PA
# spreads by 21 mm (std over 24 batches of the JAX key stream), and its
# record's 2 batches (143.2 mm) lie 1.3 sigma of a 2-batch mean above
# that stream's 24-batch mean (122.7 mm; the port's stream: 119.9), so
# 2 batches of another stream leave the +-25% window by chance (the
# port's first 2: 105.1); 8 bring the spread of the mean to ~7 mm
# (scripts/fit3d_stream_spread.py, CPU).
FIT3D_RECORDS = {"single": os.path.join("weights", "fit3d_benchmark_r04d.json"),
                 "multiview": os.path.join("weights", "fit3d_r05",
                                           "multiview.json"),
                 "track": os.path.join("weights", "fit3d_r05", "track.json")}
FIT3D_SEEDS = {"single": 20_000_000, "multiview": 30_000_000,
               "track": 40_000_000}
FIT3D_KNOBS = dict(iters=100, lr=1e-3, joint_conf_weighting=True,
                   betas_prior=0.01, pose_prior=0.0, rot_ortho_prior=0.05,
                   silh_warmup_iters=0, joints2d_scale=1e6)
FIT3D_WH, FIT3D_BATCHES = 512, 2
SV_BATCHES, SV_BATCH = 8, 8
MV_BATCH, MV_VIEWS, MV_ROUNDS, MV_ITERS = 8, 3, 3, 50
TRACK_BATCH, TRACK_FRAMES = 4, 8
# Iterations of the profiled (shortened) runs that read each fit path's
# device idle share.
PROFILE_ITERS = 10
# The broadcast-view fit's scene.
BROAD_SEED = 50_000_000
# bench.py:bench_track (BENCH_TRACK_PLAYERS=11, BENCH_TRACK_FRAMES=4): 44
# rows, 512^2 targets, 256^2 render, 100 iterations.
BENCH_TRACK_PLAYERS, BENCH_TRACK_FRAMES, BENCH_TRACK_ITERS = 11, 4, 100
# Rows of each new K1/K2 shape held against the dense plain versions
# (~0.2 s a row for K1, ~0.6 s for K2), and images of each scene pass
# against the dense plain K3.
K12_PLAIN_B = 4
K3_SCENE_PLAIN_B = 2
# The folder-tree stages on a tree from the scene factory: the JAX
# package's mint run (weights/distill_r05/mint_summary.json:
# scripts/distill_circle.py make-data and mint at --wh 512, batch 16, the
# stage fit configuration of its _fit_cfg) had 8 games x 4 scenes x 6
# players x 3 views and the broad view; one game here.
MINT_RECORD = os.path.join("weights", "distill_r05", "mint_summary.json")
TREE_SEED = 60_000_000
TREE_SCENES, TREE_PLAYERS, TREE_VIEWS, TREE_WH = 4, 6, 3, 512
MINT_KNOBS = dict(lr=1e-3, proxy_wh=TREE_WH, render_wh=256,
                  joints2d_scale=1e6, joint_conf_weighting=True,
                  betas_prior=0.01, rot_ortho_prior=0.05)
MINT_BATCH = 16
MINT_MV_BATCH = 4         # max(batch // 4, 2), as the mint ran it
STAGE_BATCH = 32          # single_view_optimization's own default
# Views of the default stage's run with its mesh overlays (each a dense
# plain 512^2 silhouette, ~0.85 s on the card; cut from the tree's 72 to
# keep the run inside its budget).
OVERLAY_VIEWS = 8
# Rows of K1/K2 at the default stage's 512^2 shape held against the dense
# plain versions (0.79 s a row for K1, 2.24 s for K2 on an H100 80GB HBM3
# at 700 W).
K12_DEFAULT_PLAIN_B = 2
# create_proxy: one RGB scene, ProxyNet at 512^2 with flip TTA.
CP_SEED = 70_000_000
CP_BATCH = 8
# cli: subprocesses over a 1-scene tree; the CLI's predict files against
# the in-process stage (the same process-independent fp32 work).
CLI_ITERS = 4
CLI_TIMEOUT_S = 300
CLI_TOL = 1e-6
# e2e_clip: the one-clip rehearsal (scripts/e2e_rehearsal.py, its record
# weights/e2e_r05/summary.json): 16 wide frames of 256 x 448 with 8
# players, 6 RGB close-ups at 256^2 centred on black frames, interleaved
# into an mp4v clip at 25 fps; harvest-frames samples 48 positions and
# keeps up to 8 frames; the single-view fit runs 4 iterations.
E2E_CLIP_RECORD = os.path.join("weights", "e2e_r05", "summary.json")
CLS_WEIGHTS = os.path.join("weights", "frame_classifier.npz")
DET_META = os.path.join("weights", "detector_256x448_f16.json")
CLIP_SEED = 80_000_000
CLIP_HW, CLIP_PLAYERS, CLIP_BATCH = (256, 448), 8, 2
CLIP_WIDE, CLIP_CLOSE, CLIP_CROP_WH, CLIP_FPS = 16, 6, 256, 25
CLIP_SAMPLES, CLIP_MAX_ACCEPTED, CLIP_ITERS = 48, 8, 4
CLIP_PROXY_FRAC = 0.75    # crops with a proxy, at least
# The classifier on the card against the same nets on the CPU (fp32, TF32
# off): features and logits within CLS_TOL of their largest magnitude
# (detector_parity's bar); a decision may differ only where the CPU's two
# logits lie within twice the measured logit gap of each other (counted).
CLS_TOL = 1e-3
# Images of the clip's K3 passes held against the dense plain version.
K3_CLIP_PLAIN_B = 2
# crop_player_stage's detector size (the CLI's default).
CROP_PLAYER_HW = (256, 256)

# Texture, attribute renders, IUV proxies and relation.
TEX_RECORD = os.path.join("weights", "texture_quality.json")
TEX_SEED = 77_000_000     # the record's seed (scripts/texture_probe.py)
TEX_BATCHES = 4
TEX_BATCH = 16
TEX_WH = 256
TEX_METRICS = ("gt_roundtrip_psnr_db", "pred_roundtrip_psnr_db",
               "pred_vs_gt_l1", "pred_vs_gt_psnr_db")
ATTR_SEED = 90_000_000
ATTR_B = 2
ATTR_WH = 512
ATTR_PARTS = 25           # DensePose ids: background + 24 parts
ATTR_NORMAL_RES = 512
ATTR_TIE_W = 1e-5         # top-two one-hot weights this close: a near-tie
ATTR_IMG_TOL = 1e-5
IUV_REL = 1e-4            # 21-channel expansion vs the 18-channel metrics
REL_WEIGHTS = {v: os.path.join("weights", "relation_v%d.npz" % v)
               for v in (0, 1)}
REL_RECORDS = {v: os.path.join("weights", "relation_v%d_eval.json" % v)
               for v in (0, 1)}
REL_SEED = 50_000_000
# The records ran 8 batches; a mean of 8 batches moves by ±1.2° of angle
# (σ 3.5° a batch), and the port's first 8 lie 2σ above the mean, the
# records' 0.5σ below it: 64 batches, where the two streams' means agree
# within 0.3° (scripts/relation_stream_spread.py).
REL_BATCHES = 64
REL_B = 8
REL_PLAYERS = 6
REL_TOL = 1e-5            # card vs CPU, fp32 with TF32 off
# The training phases, on the mint tree. distill_train: the distillation
# trainer as scripts/distill_circle.py's train phase runs it (warm start
# from the committed regressor, lr 3e-5, seed 7, --players + 2 = 8 rows a
# scene), 3 epochs and a resumed 4th (the record ran 20 on 8 games).
DISTILL_LR, DISTILL_SEED, DISTILL_PLAYERS, DISTILL_EPOCHS = 3e-5, 7, 8, 3
DISTILL_LOSS_REL = 1e-4   # first step's loss, card vs CPU (cuDNN vs CPU)
DISTILL_PROFILE_STEPS = 4
# selfsup_train: the self-supervised trainer ('both') on 8 of the tree's
# views at 512^2 and sigma 1e-4, warm-started, 10 steps; the kernels held
# to the plain route on 2 rows of one step.
SELFSUP_ROWS, SELFSUP_STEPS, SELFSUP_WH, SELFSUP_SIGMA = 8, 10, 512, 1e-4
# Adam's rate of the 10 steps. Adam's first step moves each of the 11.2 M
# parameters by about +-lr; at 1e-4 that throws the warm-started net off
# (IoU 0.60 -> 0.28, joints-2D error 34 -> 167 px), and 1e-5 is the largest
# of 1e-4, 3e-5, 1e-5, 3e-6, 1e-6 at which every step of 'both' lowered
# its loss (scripts/selfsup_lr_probe.py; NVIDIA H100 80GB HBM3, 700.00
# W). In 'both' the silhouette sum (~2e6) outweighs the joints-2D term
# (~0.05) by 1e7, so the steps follow the silhouette alone: its loss and
# the IoU must improve, and the joints-2D error is held on 10 steps of
# item 'pose' instead.
SELFSUP_LR = 1e-5
SELFSUP_PLAIN_B = 2
SELFSUP_LOSS_REL = 1e-5   # the step's loss, K1/K2 vs the plain route
SELFSUP_GRAD_REL = 1e-4   # the ResNet stem's gradient, relative L2
# relate_eval: evaluate_model and evaluate_model_relate (v0, v1) with the
# committed regressor on the tree's broadcast views, boxes from its
# scenes/, as scripts/train_relation.py relate runs them; held to
# weights/relate_eval_v{0,1}.json (192 players there, 24 here).
RELATE_RECORDS = {v: os.path.join("weights", "relate_eval_v%d.json" % v)
                  for v in (0, 1)}
RELATE_TOL = 1e-4         # one scene, card vs CPU, relative per metric
# Record vs the tree's mean, in standard errors from 4 scenes: the 0.995
# quantile of Student's t with their 3 degrees of freedom (3 would be its
# 0.971 quantile: a false failure in about 6 of 100 checks of one metric).
RELATE_SE = 5.84
# relation_train: train_relation v0 with the record's settings (b 8, 6
# players, lr 1e-3, the 3000-step schedule); the first REL_TRAIN_STEPS.
REL_TRAIN_STEPS, REL_TRAIN_SCHEDULE, REL_TRAIN_SEED = 300, 3000, 0
REL_TRAIN_LOSS_REL = 1e-4  # first 3 steps, card vs CPU
# cli_train: the train subcommand on the 1-scene tree, 1 epoch + resume.
# proxynet_train / detector_train: the perception trainers at the CLI's
# defaults (8 crops of 256^2 with occluders and IUV; 4 frames of 256 x 448
# with 6 players), lr 1e-3, from flax's initialisers (the records trained
# thousands of steps; PT_STEPS / DT_STEPS here), and warm from the
# committed weights for WARM_STEPS at WARM_LR, then evaluated against
# their records. The first step on the card is held to the CPU's from the
# same net and batch.
PT_SEED, PT_STEPS, PT_BATCH, PT_WH, PT_LR = 91_000_000, 20, 8, 256, 1e-3
DT_SEED, DT_STEPS, DT_BATCH, DT_HW, DT_PLAYERS = (92_000_000, 12, 4,
                                                  (256, 448), 6)
WARM_STEPS, WARM_LR = 4, 1e-5
PT_LOSS_REL = 1e-4        # first step's losses, card vs CPU
PT_STATS_REL = 1e-4       # its BN running statistics
PT_FLIP_SHARE = 0.01      # parameters apart by Adam's sign flips (<= 2 lr)
K3_TRAIN_PLAIN_B = 1      # images of the plain K3 at the training shapes
# classifier_train: the head on the committed feature net's features of
# build_dataset frames (the record: 384 + 96 frames, in PERF.md).
CLS_TRAIN_FRAMES, CLS_TRAIN_EPOCHS, CLS_TRAIN_SEED = 64, 10, 3
CLS_TRAIN_TOL = 1e-4      # first epoch's head and loss, card vs CPU
# real_data_train: the create-proxy scene's crops and proxies mixed with
# synthetic crops, warm ProxyNet steps.
RD_SEED, RD_BATCH, RD_STEPS, RD_P_REAL = 93_000_000, 8, 4, 0.5
# extracted_train: one extracted batch of the e2e shape, one distillation
# step on it.
EX_SEED, EX_B, EX_WH = 94_000_000, 16, 256
# baselines: the committed regressor's predictions on the mint tree's
# first scene as HMR / SPIN files, fitted at the stages' defaults.
BASE_HMR_TOL = 1e-4       # body joints through axis-angle and back
# One player's short joints-only fit, card vs CPU (the CPU's dense 32^2
# silhouette costs ~20 s a player here; K1/K2 are held to their plain
# versions at the baselines' rows below).
BASE_CPU_KNOBS = dict(iters=3, lr=1e-3, use_silhouette=False,
                      silhouette_metrics=False)
BASE_CPU_TOL = 1e-4
BASE_K12_PLAIN_B = 1
CLI_PT_STEPS = 2          # train-perception's steps per subprocess
# parallel: the data- and model-parallel layer at the default single-view
# stage's batch (32 rows, 512^2 render), 20 of its 100 iterations, the
# mint chain's priors (one scalar all-reduce an iteration). NCCL runs at
# world size 1 in this process (one card); cross-rank equality is held on
# two gloo ranks on cuda:0 (16 rows each).
PAR_SEED, PAR_ROWS, PAR_ITERS = 95_000_000, 32, 20
# The pair's fit is held to the one-process card fit at the CPU tests'
# silhouette bars after their 3 iterations: over 20 iterations at 512^2
# fp32 differences of a few ulps (cuBLAS picks other algorithms for 16
# rows than for 32) grow far past them (the phase reports that gap).
PAR_HELD_ITERS = 3
PAR_PRIORS = dict(betas_prior=0.01, rot_ortho_prior=0.05)
PAR_WS1_TOL = 1e-6        # sharded at world size 1 vs the plain loop
PAR_JOINT_REL = 1e-5      # the pair's fit vs the one-process card fit
PAR_STATS_REL = 3.5e-6    # the pair's ProxyNet step: BN statistics
PAR_DISTILL_B = 8         # the (1, 2) grid's distillation batch
PAR_DISTILL_LR = 1e-3
PAR_DISTILL_REL = 2e-5    # its losses; parameters as PT_FLIP_SHARE
PAR_TIMEOUT_S = 300
# train_perception: the training drivers (scripts/train_perception_torch.py)
# in this process. The r05 regressor fine-tune (scripts/tpu_queue_r5.sh)
# cut from 1500 steps to TPD_STEPS in segments of TPD_SEGMENT, its 4
# evaluation batches to 1, warm from the committed regressor, its
# extracted batches through ProxyNet 256 into a keyed cache of
# TPD_EXTRACT_BATCHES slots; the same run again as two resumed segments,
# bit for bit; the r05 weights' clean and e2e evaluations against their
# records; a short ProxyNet drive.
R05_WEIGHTS = os.path.join("weights", "regressor_r05", "weights_last.npz")
R05_RECORDS = {"clean": os.path.join("weights", "regressor_r05",
                                     "clean_eval.json"),
               "e2e": os.path.join("weights", "regressor_r05",
                                   "e2e_eval.json")}
R05_METRICS = ("mpjpe_pa_mm", "pve_pa_mm", "mpjpe_mm", "pve_mm",
               "joints2d_l2_px")
R05_WH = {"clean": 512, "e2e": 256}
R05_BATCHES, R05_BATCH = 4, 16
TPD_STEPS, TPD_SEGMENT, TPD_BATCH, TPD_WH, TPD_LR = 6, 3, 16, 256, 3e-5
TPD_EXTRACT_BATCHES, TPD_EVAL_BATCHES = 2, 1
PND_STEPS, PND_SEGMENT, PND_BATCH, PND_WH = 4, 2, 8, 256
K3_DRIVER_PLAIN_B = 2     # images of the plain K3 at the regressor's batch
RS_STEPS, RS_EVAL_BATCHES = 20, 2   # train_relation_torch.py, v0 defaults

_T0 = time.time()
# What a run started and must stop or remove if the budget cuts it off:
# the command-line subprocesses and the trees' directory.
_CHILDREN = []
_WORK_DIRS = []


def _on_alarm(signum, frame):
    sys.stdout.write(json.dumps({"phase": "timeout", "budget_s": BUDGET_S})
                     + "\n")
    sys.stdout.flush()
    for child in _CHILDREN:
        child.kill()
    for path in _WORK_DIRS:
        shutil.rmtree(path, ignore_errors=True)
    os._exit(3)


def emit(phase: str, t_start: float, **kw) -> None:
    rec = {"phase": phase, "s": round(time.time() - t_start, 3)}
    rec.update(kw)
    print(json.dumps(rec), flush=True)


def timed(acc: dict, key: str, fn):
    """``fn`` wrapped to add its wall time to ``acc[key]``."""
    def wrapper(*a, **kw):
        t0 = time.time()
        try:
            return fn(*a, **kw)
        finally:
            acc[key] = acc.get(key, 0.0) + time.time() - t0
    return wrapper


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


def _parallel_inputs(assets, dev):
    """The parallel phase's rows: PAR_ROWS bodies of the bench scene's
    distribution (seed PAR_SEED), their 512^2 silhouettes (K1) and
    keypoints as targets, a perturbed init; on ``dev``."""
    import numpy as np
    import torch
    from soccerplayershapepose_torch import config as cfg
    from soccerplayershapepose_torch.fit.engine import FitInit
    from soccerplayershapepose_torch.ops import (
        batch_rodrigues, orthographic_project, undo_keypoint_normalisation,
        weak_perspective_to_translation)
    from soccerplayershapepose_torch.render import softras
    from soccerplayershapepose_torch.smpl import smpl_forward
    aa, betas, cam, _, _ = bench_scene(PAR_ROWS, seed=PAR_SEED)
    rot = batch_rodrigues(torch.from_numpy(aa)).to(dev)
    betas, cam = torch.from_numpy(betas).to(dev), torch.from_numpy(cam).to(dev)
    with torch.no_grad():
        out = smpl_forward(assets, betas, rot[:, 1:], rot[:, :1])
        kp = torch.as_tensor(cfg.SMPL_TO_KPRCNN_MAP, device=dev)
        j2d = undo_keypoint_normalisation(
            orthographic_project(out.joints, cam)[:, kp], PROXY_WH)
        sil = (softras.render_silhouette(
            out.vertices, weak_perspective_to_translation(
                cam, cfg.FOCAL_LENGTH, PROXY_WH), assets.faces, PROXY_WH,
            cfg.FOCAL_LENGTH, backface_cull=True) > 0.5).float()
    noise = batch_rodrigues(torch.from_numpy(np.random.RandomState(
        PAR_SEED + 1).randn(PAR_ROWS, 24, 3).astype(np.float32) * 0.2))
    noisy = torch.einsum("bjxy,bjyz->bjxz", rot, noise.to(dev))
    init = FitInit(noisy[:, 1:].contiguous(), noisy[:, :1].contiguous(),
                   betas + 0.3,
                   cam + torch.tensor([0.05, 0.02, -0.02], device=dev))
    return init, sil, j2d


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms on, inside: the fit's gathers
    backpropagate through atomic adds, so two runs of the same fit on the
    card differ after a few iterations (the parallel phase compares fits
    bit for bit)."""
    import torch
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _fit_fields(res) -> dict:
    return {k: getattr(res, k).detach().cpu() for k in (
        "body_pose", "global_orient", "betas", "cam_wp", "translation",
        "silh_iou", "joint_err", "init_silh_iou", "init_joint_err",
        "best_iter")}


def _pair_inputs(assets, dev) -> dict:
    """The inputs of the parallel phase's steps, on the CPU: the fit's rows
    (:func:`_parallel_inputs`), ProxyNet's PT_BATCH crops of PT_WH^2
    synthesised on ``dev`` (K3) and its initial weights, the regressor's
    initial weights and the distillation batch."""
    import torch
    from soccerplayershapepose_torch.entry import dryrun_batch
    from soccerplayershapepose_torch.train import distill, synth
    from soccerplayershapepose_torch.train import perception as ptrain
    init, sil, j2d = _parallel_inputs(assets, dev)
    draws = synth.sample_crop_draws(torch.Generator().manual_seed(
        PAR_SEED + 2), PT_BATCH, image_wh=PT_WH)
    pbatch = synth.render_crop_batch(assets, draws, PT_WH, with_image=True)
    net = ptrain.new_proxynet(torch.Generator().manual_seed(PAR_SEED + 3),
                              device="cpu")
    reg = distill.new_regressor(18, seed=PAR_SEED, device="cpu")
    return {"init": [x.cpu() for x in init], "sil": sil.cpu(),
            "j2d": j2d.cpu(), "pn_state": net.state_dict(),
            "pn_batch": {k: v.cpu() for k, v in pbatch.items()},
            "reg_state": reg.state_dict(),
            "d_batch": dryrun_batch(PAR_DISTILL_B)}


def _pair_work(assets, dev, mesh, grid, inp: dict, profile: bool) -> dict:
    """One rank's share of the pair's work on ``inp``: the sharded fit on
    ``mesh`` (16 of the 32 rows a rank, every row returned) for PAR_ITERS
    iterations with its K1/K2 launches counted; ProxyNet's sharded step (4
    of the 8 crops a rank, global batch norm); the distillation step on
    the (1, 2) ``grid`` (the IEF's 669 -> 512 and 512 -> 512 layers
    column-parallel, the whole batch on each rank); with ``profile``, the
    fit for PAR_HELD_ITERS iterations under the profiler (K1/K2 per
    launch)."""
    import torch
    from soccerplayershapepose_torch import parallel
    from soccerplayershapepose_torch.fit import FitConfig, single_view_fit
    from soccerplayershapepose_torch.models.perception import ProxyNet
    from soccerplayershapepose_torch.models.regressor import (
        SingleInputRegressor)
    from soccerplayershapepose_torch.render import band_raster as br
    from soccerplayershapepose_torch.train import distill
    from soccerplayershapepose_torch.train import perception as ptrain
    out = {"split_s": {}}
    t_split = time.time()

    def split(name):
        nonlocal t_split
        torch.cuda.synchronize()
        out["split_s"][name] = time.time() - t_split
        t_split = time.time()

    init = [x.to(dev) for x in inp["init"]]
    sil, j2d = inp["sil"].to(dev), inp["j2d"].to(dev)
    fit_cfg = FitConfig(iters=PAR_ITERS, **PAR_PRIORS)
    br.reset_launch_counts()
    t0 = time.time()
    with deterministic():
        res = single_view_fit(assets, init, sil, j2d, fit_cfg, device=dev,
                              mesh=mesh)
    torch.cuda.synchronize()
    out["fit_s"] = time.time() - t0
    out["fit_launches"] = dict(br.LAUNCHES)
    out["fit"] = _fit_fields(res)
    split("fit")

    net = ProxyNet()
    net.load_state_dict(inp["pn_state"])
    state = ptrain.make_perception_state(net.to(dev), PT_LR)
    batch = parallel.shard_batch({k: v.to(dev) for k, v in
                                  inp["pn_batch"].items()}, mesh)
    torch.cuda.synchronize()
    t0 = time.time()
    state, losses = ptrain.shard_train_step(
        ptrain.make_proxynet_train_step(), mesh)(state, batch)
    torch.cuda.synchronize()
    out["pn_s"] = time.time() - t0
    out["pn_losses"] = {k: float(v) for k, v in losses.items()}
    out["pn_state"] = {k: v.cpu() for k, v in net.state_dict().items()}
    split("proxynet")

    reg = SingleInputRegressor(in_channels=18)
    reg.load_state_dict(inp["reg_state"])
    dstate = distill.make_train_state(reg.to(dev),
                                      learning_rate=PAR_DISTILL_LR)
    distill.shard_train_state(dstate, grid)
    dbatch = {k: v.to(dev) for k, v in inp["d_batch"].items()}
    torch.cuda.synchronize()
    t0 = time.time()
    dstate, metrics, _ = distill.make_train_step(mesh=grid)(
        dstate, assets, parallel.shard_batch(dbatch, grid))
    torch.cuda.synchronize()
    out["d_s"] = time.time() - t0
    out["d_metrics"] = {k: float(v) for k, v in metrics.items()}
    out["d_log_vars"] = {k: float(v.detach())
                         for k, v in dstate.log_vars.items()}
    out["d_state"] = {k: v.cpu() for k, v in distill.gather_regressor(
        dstate, grid).items()}
    out["d_split"] = [n for n, m in reg.named_modules()
                      if type(m).__name__ == "ColumnParallelLinear"]
    split("distill")

    # Last, as a profiler session slows the launches after it.
    if not profile:
        return out
    with deterministic(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out["held_fit"] = _fit_fields(single_view_fit(
            assets, init, sil, j2d, dataclasses.replace(
                fit_cfg, iters=PAR_HELD_ITERS), device=dev, mesh=mesh))
        torch.cuda.synchronize()
    k12 = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name, tag in (("band_raster_fwd", "band_fwd"),
                          ("band_raster_bwd", "band_bwd")):
            if tag in ev.key:
                us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0))
                n, tot = k12.get(name, (0, 0.0))
                k12[name] = (n + ev.count, tot + us / 1e3)
    out["k12_profile"] = {k: {"launches": n, "ms_per_launch": tot / n}
                          for k, (n, tot) in k12.items() if n}
    split("held_fit")
    return out


def _parallel_rank(rank: int, world: int, work: str, parent: int,
                   ready, go) -> None:
    """One of the parallel phase's two gloo ranks on cuda:0, started early
    (:func:`start_parallel_pair`): it reaches the card, joins the pair and
    runs :func:`_pair_work` once on inputs of its own (the same seeds), so
    that the first call's costs (the card's libraries, gloo on CUDA
    tensors) fall outside the phase; then it leaves the pair, reports on
    ``ready`` and waits for ``go``. After ``go`` it joins a new pair, runs
    the work on the inputs the phase saved, gathers every rank's K1/K2
    counts, and rank 0 saves what the pair gives."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    from soccerplayershapepose_torch import _build, parallel
    from soccerplayershapepose_torch.smpl import synthesize_assets
    t_start = time.time()
    _build.load_library()
    parallel.initialize("file://" + os.path.join(work, "rendezvous"), world,
                        rank, backend="gloo", device="cuda")
    dev = torch.device("cuda", 0)
    assets = synthesize_assets(device=dev)
    mesh, grid = parallel.make_mesh(), parallel.make_mesh(model_parallel=2)
    t_warm = time.time()
    _pair_work(assets, dev, mesh, grid, _pair_inputs(assets, dev), False)
    torch.cuda.empty_cache()
    # A live gloo group keeps a core's fraction busy while idle (on the
    # card machine's build), each group its own: leave the pair until
    # ``go``, dropping the meshes' references so their groups end too.
    del mesh, grid
    dist.destroy_process_group()
    gc.collect()
    ready.put((rank, t_warm - t_start, time.time() - t_warm))
    # The wait's CPU seconds (every thread of the process): what the
    # waiting rank takes from the host while the other phases run.
    t_idle, cpu_idle = time.time(), time.process_time()
    deadline = time.time() + BUDGET_S
    while not go.wait(5.0):
        if os.getppid() != parent or time.time() > deadline:
            os._exit(1)
    idle = {"wall_s": round(time.time() - t_idle, 3),
            "cpu_s": round(time.process_time() - cpu_idle, 3)}
    t_start = time.time()
    parallel.initialize("file://" + os.path.join(work, "rendezvous_run"),
                        world, rank, backend="gloo", device="cuda")
    mesh, grid = parallel.make_mesh(), parallel.make_mesh(model_parallel=2)
    out = {"rejoin_s": time.time() - t_start}
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    out.update(_pair_work(assets, dev, mesh, grid, inp, True))
    by_rank = [None] * world
    dist.all_gather_object(by_rank, (out["fit_launches"], idle))
    out["fit_launches_by_rank"] = [n for n, _ in by_rank]
    out["idle_by_rank"] = [i for _, i in by_rank]
    out["wall_s"] = time.time() - t_start
    if rank == 0:
        torch.save(out, os.path.join(work, "rank0.pt"))
    dist.barrier()
    dist.destroy_process_group()


def start_parallel_pair(root: str) -> dict:
    """Start the parallel phase's two gloo ranks (daemons: they end with
    this process); they warm up while the earlier phases run."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    work = tempfile.mkdtemp(prefix="_smoke_par_", dir=root)
    _WORK_DIRS.append(work)
    pair = {"work": work, "ready": ctx.Queue(), "go": ctx.Event(),
            "t_start": time.time(), "warm": {}}
    pair["procs"] = [ctx.Process(target=_parallel_rank, args=(
        r, 2, work, os.getpid(), pair["ready"], pair["go"]), daemon=True)
        for r in range(2)]
    for p in pair["procs"]:
        p.start()
        _CHILDREN.append(p)
    return pair


def wait_parallel_pair(pair: dict) -> None:
    """Wait until both ranks have warmed up (they must, before a phase
    that times the card); fails if a rank died or PAR_TIMEOUT_S passed."""
    import queue
    deadline = pair["t_start"] + PAR_TIMEOUT_S
    while len(pair["warm"]) < 2:
        dead = [r for r, p in enumerate(pair["procs"]) if not p.is_alive()]
        check(not dead and time.time() < deadline,
              "the gloo pair on cuda:0 did not warm up: ranks %s ended "
              "(exit codes %s), %d s budget" % (dead, [
                  p.exitcode for p in pair["procs"]], PAR_TIMEOUT_S))
        try:
            rank, start_s, warm_s = pair["ready"].get(timeout=1.0)
        except queue.Empty:
            continue
        pair["warm"][rank] = {"start_s": round(start_s, 3),
                              "warm_up_s": round(warm_s, 3)}
        pair["ready_after_s"] = round(time.time() - pair["t_start"], 3)


def state_gaps(got: dict, want: dict, lr: float) -> dict:
    """Two state dicts after one step from the same state: BN statistics'
    largest gap relative to their scale, and the parameters more than 1e-6
    apart (Adam's sign flips), each at most 2 lr."""
    stats_rel, flips, total = 0.0, 0, 0
    for k, w in want.items():
        g = got[k].cpu()
        w = w.cpu()
        if "running_" in k:
            stats_rel = max(stats_rel, float((g - w).abs().max())
                            / max(float(w.abs().max()), 1e-12))
        elif w.is_floating_point():
            gap = (g - w).abs()
            check(bool((gap <= 2 * lr + 1e-6).all()),
                  "%s moved apart by %.3g in one step" % (k, float(gap.max())))
            flips += int((gap > 1e-6).sum())
            total += gap.numel()
    return {"bn_stats_rel": stats_rel, "adam_sign_flips": flips,
            "params": total}


def parallel_phase(pair, assets, dev, counted, smi) -> tuple:
    """The ``parallel`` phase: returns the K1/K2 and K3 launches by path."""
    import torch
    import torch.distributed as dist
    from soccerplayershapepose_torch import parallel
    from soccerplayershapepose_torch.fit import FitConfig, single_view_fit
    from soccerplayershapepose_torch.models.perception import ProxyNet
    from soccerplayershapepose_torch.models.regressor import (
        SingleInputRegressor)
    from soccerplayershapepose_torch.train import distill
    from soccerplayershapepose_torch.train import perception as ptrain
    t = time.time()
    # The inputs: the fit's rows, ProxyNet's batch (K3), the nets.
    inp, _, _, pn_k3 = counted(lambda: _pair_inputs(assets, dev))
    check(pn_k3 == 2, "the ProxyNet batch launched K3 %d times" % pn_k3)
    torch.save(inp, os.path.join(pair["work"], "inputs.pt"))
    init = [x.to(dev) for x in inp["init"]]
    sil, j2d = inp["sil"].to(dev), inp["j2d"].to(dev)
    fit_cfg = FitConfig(iters=PAR_ITERS, **PAR_PRIORS)
    warm = dataclasses.replace(fit_cfg, iters=2)

    # NCCL at world size 1, in this process: the sharded fit (one
    # all-reduce of the counts, one of |total| an iteration, one
    # all-gather) against the plain loop on the same rows, both with
    # deterministic algorithms; the pair waits meanwhile.
    t_nccl = time.time()
    single_view_fit(assets, init, sil, j2d, warm, device=dev)
    with deterministic():
        plain, plain_s, plain_k12, _ = counted(lambda: single_view_fit(
            assets, init, sil, j2d, fit_cfg, device=dev))
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = parallel.make_mesh()
        single_view_fit(assets, init, sil, j2d, warm, device=dev, mesh=mesh)
        with deterministic():
            sharded, sharded_s, sharded_k12, _ = counted(
                lambda: single_view_fit(assets, init, sil, j2d, fit_cfg,
                                        device=dev, mesh=mesh))
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    want = _fit_fields(plain)
    ws1 = {k: float((v.float() - want[k].float()).abs().max())
           for k, v in _fit_fields(sharded).items()}
    bit_equal = all(torch.equal(v, want[k])
                    for k, v in _fit_fields(sharded).items())
    for k12 in (plain_k12, sharded_k12):
        check(k12 == {"band_raster_fwd": PAR_ITERS,
                      "band_raster_bwd": PAR_ITERS},
              "the parallel phase's fits launched K1/K2 %s times" % k12)
    check(max(ws1.values()) <= PAR_WS1_TOL,
          "the sharded fit at world size 1 differs from the plain loop: %s"
          % ws1)
    nccl_s = time.time() - t_nccl

    # The pair's one-process references on the card.
    t_refs = time.time()
    with deterministic():
        held = _fit_fields(single_view_fit(
            assets, init, sil, j2d, dataclasses.replace(
                fit_cfg, iters=PAR_HELD_ITERS), device=dev))
    net = ProxyNet()
    net.load_state_dict(inp["pn_state"])
    st = ptrain.make_perception_state(net.to(dev), PT_LR)
    _, pn_losses = ptrain.make_proxynet_train_step()(
        st, {k: v.to(dev) for k, v in inp["pn_batch"].items()})
    pn_want = {k: v.cpu() for k, v in net.state_dict().items()}
    reg = SingleInputRegressor(in_channels=18)
    reg.load_state_dict(inp["reg_state"])
    dst = distill.make_train_state(reg.to(dev), learning_rate=PAR_DISTILL_LR)
    dst, d_metrics, _ = distill.make_train_step()(
        dst, assets, {k: v.to(dev) for k, v in inp["d_batch"].items()})
    d_want = {k: v.cpu() for k, v in dst.regressor.state_dict().items()}
    torch.cuda.synchronize()
    refs_s = time.time() - t_refs

    # Two gloo ranks on cuda:0, warmed up and waiting: the fit, ProxyNet's
    # step and the (1, 2) grid's distillation step, alone on the card.
    wait_parallel_pair(pair)
    t_pair = time.time()
    pair["go"].set()
    procs = pair["procs"]
    for p in procs:
        p.join(max(t_pair + PAR_TIMEOUT_S - time.time(), 1.0))
    pair_s = time.time() - t_pair
    late = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    check(not late and all(p.exitcode == 0 for p in procs),
          "the gloo pair on cuda:0 failed: exit codes %s, ranks %s past %d s"
          % ([p.exitcode for p in procs], late, PAR_TIMEOUT_S))
    got = torch.load(os.path.join(pair["work"], "rank0.pt"),
                     weights_only=False)
    shutil.rmtree(pair["work"], ignore_errors=True)

    # The pair's fit against the one-process card fit, after the CPU
    # tests' 3 iterations at their silhouette bars; the 20-iteration gap
    # is reported.
    fit_gap = {k: float((v.float() - held[k].float()).abs().max())
               for k, v in got["held_fit"].items()}
    check(torch.equal(got["held_fit"]["best_iter"], held["best_iter"]),
          "the pair's best iterations differ from the one-process fit's")
    for k in ("body_pose", "global_orient", "betas", "cam_wp"):
        check(fit_gap[k] <= FIT_PARAM_TOL, "the pair's fit: %s %.3g apart"
              % (k, fit_gap[k]))
    check(fit_gap["translation"] <= FIT_PARAM_TOL * 200
          and fit_gap["silh_iou"] <= 1e-6
          and fit_gap["init_silh_iou"] <= 1e-6,
          "the pair's fit: %s" % fit_gap)
    for k in ("joint_err", "init_joint_err"):
        rel = float(((got["held_fit"][k] - held[k]).abs()
                     / held[k].abs().clamp(min=1e-12)).max())
        check(rel <= PAR_JOINT_REL, "the pair's fit: %s %.3g relative"
              % (k, rel))
    gap20 = {k: float((v.float() - want[k].float()).abs().max())
             for k, v in got["fit"].items()}
    by_rank = got["fit_launches_by_rank"]
    for r, n in enumerate(by_rank):
        check(n == {"band_raster_fwd": PAR_ITERS,
                    "band_raster_bwd": PAR_ITERS},
              "rank %d of the pair launched K1/K2 %s times" % (r, n))

    # ProxyNet's step: split 4 + 4 against the whole batch on the card.
    pn_rel = {k: abs(got["pn_losses"][k] - float(v))
              / max(abs(float(v)), 1e-12) for k, v in pn_losses.items()}
    pn_gap = state_gaps(got["pn_state"], pn_want, PT_LR)
    check(max(pn_rel.values()) <= PT_LOSS_REL
          and pn_gap["bn_stats_rel"] <= PAR_STATS_REL
          and pn_gap["adam_sign_flips"] <= PT_FLIP_SHARE * pn_gap["params"],
          "the pair's ProxyNet step vs one process: losses %s, %s"
          % (pn_rel, pn_gap))

    # The (1, 2) grid's distillation step against the unsplit step.
    check(got["d_split"] == ["ief.fcs.0", "ief.fcs.1"],
          "the (1, 2) grid split %s" % got["d_split"])
    d_rel = {k: abs(got["d_metrics"][k] - float(v))
             / max(abs(float(v)), 1e-12) for k, v in d_metrics.items()}
    d_gap = state_gaps(got["d_state"], d_want, PAR_DISTILL_LR)
    lv_gap = max(abs(got["d_log_vars"][k] - float(v.detach()))
                 for k, v in dst.log_vars.items())
    check(max(d_rel.values()) <= PAR_DISTILL_REL and lv_gap <= 1e-6
          and d_gap["bn_stats_rel"] <= 1e-5
          and d_gap["adam_sign_flips"] <= PT_FLIP_SHARE * d_gap["params"],
          "the (1, 2) grid's distillation step vs the unsplit one: losses "
          "%s, log-variances %.3g, %s" % (d_rel, lv_gap, d_gap))

    iters_s = {"plain": plain_s, "nccl_ws1": sharded_s}
    emit("parallel", t, rows=PAR_ROWS, render_wh=PROXY_WH, iters=PAR_ITERS,
         priors=PAR_PRIORS, nccl_backend=backend,
         ms_per_iter={k: round(v / PAR_ITERS * 1e3, 3)
                      for k, v in iters_s.items()},
         ws1_max_abs=ws1, ws1_bit_equal=bit_equal, ws1_tol=PAR_WS1_TOL,
         deterministic_algorithms=True, nccl_comparison_s=round(nccl_s, 3),
         references_s=round(refs_s, 3),
         pair={"backend": "gloo", "device": "cuda:0", "ranks": 2,
               "rows_per_rank": PAR_ROWS // 2,
               "started_before_phase_s": round(t - pair["t_start"], 3),
               "ready_after_s": pair["ready_after_s"],
               "warm_up_by_rank": pair["warm"],
               "waiting_by_rank": got["idle_by_rank"],
               "wall_s": round(pair_s, 3),
               "rank0_wall_s": round(got["wall_s"], 3),
               "rank0_rejoin_s": round(got["rejoin_s"], 3),
               "rank0_split_s": {k: round(v, 3)
                                 for k, v in got["split_s"].items()},
               "fit_ms_per_iter": round(got["fit_s"] / PAR_ITERS * 1e3, 3),
               "held_iters": PAR_HELD_ITERS,
               "held_fit_max_abs_vs_one_process": fit_gap,
               "fit_%d_iters_max_abs_vs_one_process" % PAR_ITERS: gap20,
               "k12_profile": got["k12_profile"],
               "k12_launches_by_rank": by_rank,
               "proxynet_step_ms": round(got["pn_s"] * 1e3, 3),
               "proxynet_loss_rel": pn_rel, "proxynet_state": pn_gap,
               "distill_step_ms": round(got["d_s"] * 1e3, 3),
               "distill_loss_rel": d_rel, "distill_log_var_gap": lv_gap,
               "distill_state": d_gap, "distill_split": got["d_split"]},
         k3_launches_proxynet_batch=pn_k3, nvidia_smi=smi)
    k12_paths = {"parallel_plain": plain_k12,
                 "parallel_nccl_ws1": sharded_k12,
                 "parallel_gloo_pair": {
                     k: sum(n[k] for n in by_rank) for k in by_rank[0]}}
    return k12_paths, {"parallel_proxynet_batch": pn_k3}


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
        from soccerplayershapepose_torch.render import vis as vis_mod
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
        from soccerplayershapepose_torch.fit import (
            MultiViewInit, TrackInit, broad_view_fit, multi_view_fit,
            track_fit)
        from soccerplayershapepose_torch.train import fit3d, scenes
        from soccerplayershapepose_torch.drivers import stages
        from soccerplayershapepose_torch.io import formats as io_formats
        from soccerplayershapepose_torch.io import native
        from soccerplayershapepose_torch.pipeline.densepose import decode_png
        from soccerplayershapepose_torch.pipeline.extract import (
            create_proxy_stage)
        from soccerplayershapepose_torch.drivers import training
        from soccerplayershapepose_torch.train import distill, selfsup
        from soccerplayershapepose_torch.train import relation as rel_train
        from soccerplayershapepose_torch.train import perception as ptrain
        from soccerplayershapepose_torch.train import real_data
        from soccerplayershapepose_torch.drivers import baselines
        from soccerplayershapepose_torch.ops import rotmat_to_axis_angle
        from soccerplayershapepose_torch.convert import (
            load_classifier_weights)
        from soccerplayershapepose_torch.models.classifier import (
            ClassifyNet)
        from soccerplayershapepose_torch.models.init import flax_init_
        from soccerplayershapepose_torch.pipeline.classification import (
            train_classifier)
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "train_classifier_torch", os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "scripts",
                "train_classifier_torch.py"))
        cls_script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cls_script)
        spec = importlib.util.spec_from_file_location(
            "train_perception_torch", os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "scripts",
                "train_perception_torch.py"))
        tp_script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tp_script)
        spec = importlib.util.spec_from_file_location(
            "train_relation_torch", os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "scripts",
                "train_relation_torch.py"))
        tr_script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tr_script)
    except (ImportError, FileNotFoundError) as e:
        print("chip_smoke: the port is not beside this script (%s)" % e,
              file=sys.stderr)
        return 2
    import numpy as np
    root = os.path.dirname(os.path.abspath(__file__))
    for path in (WEIGHTS, RECORD, E2E_RECORD, PN_WEIGHTS[256],
                 PN_RECORDS[256], PN_WEIGHTS[512], DET_WEIGHTS, DET_RECORD,
                 *FIT3D_RECORDS.values(), MINT_RECORD, E2E_CLIP_RECORD,
                 CLS_WEIGHTS, DET_META, TEX_RECORD, *REL_WEIGHTS.values(),
                 *REL_RECORDS.values(), *RELATE_RECORDS.values(),
                 R05_WEIGHTS, *R05_RECORDS.values()):
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
    # The parallel phase's gloo pair reaches the card and warms up while
    # the parity phases run; the timed phases start once it waits.
    pair = start_parallel_pair(root)

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
    wait_parallel_pair(pair)
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
    k12_launches = {"fit": launches}
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

    def k12_case(v2d, wh, plain_b=None, sigma=SIGMA):
        """K1 and K2 at one path's shape (B = v2d's rows, wh^2, ``sigma``):
        timed, held against their plain versions on the first ``plain_b``
        rows (default all) of the same launch, and each evaluating exactly
        the pairs inside the faces' boxes padded by the support radius.
        Returns the case's record; ``_launch`` and ``_out`` hold the
        launchers and their outputs for the caller."""
        b = v2d.shape[0]
        pb = b if plain_b is None else plain_b
        args, sigma_px, margin = band_inputs(v2d, wh, sigma)
        fc, cymin, cymax, cxmin, cxmax, lo, hi = args
        s = br.launch_fwd(*args, wh, sigma_px, margin)
        gw = torch.randn(s.shape, generator=gen, device=dev)
        gs = (gw * (1.0 - s)).contiguous()
        launch = {
            "band_raster_fwd": lambda n=None: br.launch_fwd(
                *args, wh, sigma_px, margin, pair_count=n),
            "band_raster_bwd": lambda n=None: br.launch_bwd(
                fc, gs, wh, sigma_px, pair_count=n)}
        plain = {
            "band_raster_fwd": lambda: br.band_raster_fwd_plain(
                fc[:pb], wh, sigma_px),
            "band_raster_bwd": lambda: br.band_raster_bwd_plain(
                fc[:pb], gs[:pb], wh, sigma_px)}
        k_ms, k_out, plain_ms, plain_out, evaluated = {}, {}, {}, {}, {}
        for k in launch:
            k_ms[k], k_out[k] = time_ms(launch[k], 20)
            # One call of the plain version: at seconds a call, a warm-up
            # call would double its cost and move its time by noise only.
            plain_ms[k], plain_out[k] = time_ms(plain[k], 1, warmup=0)
            evaluated[k] = pairs_evaluated(launch[k])
        # The kernels against their plain versions at the path's shape.
        max_abs = {k: float((k_out[k][:pb] - plain_out[k]).abs().max())
                   for k in k_out}
        k2_rel = rel_l2(k_out["band_raster_bwd"][:pb],
                        plain_out["band_raster_bwd"])
        check(all(bool(torch.isfinite(v).all()) for v in k_out.values()),
              "a kernel's output is not finite at B=%d %d^2" % (b, wh))
        check(max_abs["band_raster_fwd"] <= K1_TOL,
              "K1 disagrees with its plain version at B=%d %d^2: %.3g"
              % (b, wh, max_abs["band_raster_fwd"]))
        check(k2_rel <= K2_TOL,
              "K2 disagrees with its plain version at B=%d %d^2: %.3g"
              % (b, wh, k2_rel))
        # The work these inputs need: the pairs whose pixel centre lies in
        # a live face's box padded by the support radius, whatever the
        # design. The chunk-level count (every face of a chunk that meets
        # an 8 x 32 tile, at all its pixels: the work of the first port's
        # kernels) is kept beside it as history.
        support = br.support_pairs(fc[..., br.BOX], wh)
        check(all(n == support for n in evaluated.values()),
              "the kernels evaluated %s pairs, the padded boxes hold %d at "
              "B=%d %d^2" % (evaluated, support, b, wh))
        n_chunks, n_bands = cymin.shape[1], lo.shape[1]
        n_cv, all_chunk_visits = chunk_visits(
            cymin, cymax, cxmin, cxmax, lo, hi, wh, br.BAND_H, br.TILE_W,
            margin)
        visits_chunk_level = n_cv * br.CHUNK * br.BAND_H * br.TILE_W
        f_pad = fc.shape[1]
        # Each input read once: the triangles (24 bytes a face; the 80-byte
        # records are derived from them), the chunk boxes and band bounds
        # for K1, g(1 - S) for K2; each output written once.
        tri_bytes = b * f_pad * 6 * 4
        img_bytes = b * wh * wh * 4
        bytes_moved = {
            "band_raster_fwd": (tri_bytes + 4 * b * n_chunks * 4
                                + 2 * b * n_bands * 4 + img_bytes),
            "band_raster_bwd": 2 * tri_bytes + img_bytes}
        bound = {k: roofline_ms(support * FLOPS_PER_PAIR[k], bytes_moved[k])
                 for k in k_ms}
        return {
            "b": b, "wh": wh, "sigma": sigma, "plain_b": pb,
            "support_radius_px": br.support_radius(sigma_px),
            "support_pairs": support, "pairs_evaluated": evaluated,
            "chunk_visits": n_cv, "chunk_visits_unpruned": all_chunk_visits,
            "visits_chunk_level": visits_chunk_level,
            # K1's gather: every x-tile of a band tests each face of the
            # band's [lo, hi) once.
            "k1_faces_scanned": int((hi - lo).clamp(min=0).sum()) * br.CHUNK
            * (-(-wh // br.TILE_W)),
            "k1_max_abs": max_abs["band_raster_fwd"], "k2_rel_l2": k2_rel,
            "k2_max_abs": max_abs["band_raster_bwd"], "ms": k_ms,
            "plain_ms": plain_ms,
            "bound_ms": {k: v[0] for k, v in bound.items()},
            "bound_by": {k: v[1] for k, v in bound.items()},
            "bound_ms_chunk_level": {
                k: roofline_ms(visits_chunk_level * FLOPS_PER_PAIR[k],
                               bytes_moved[k])[0] for k in k_ms},
            "bytes_moved": bytes_moved, "max_abs": max_abs}

    k12 = [dict(k12_case(posed_verts2d(FIT_BATCH, FIT_RENDER_WH),
                         FIT_RENDER_WH), path="fit")]
    emit("timing", t, band_h=br.BAND_H, tile_w=br.TILE_W, chunk=br.CHUNK,
         **{k: v for k, v in k12[0].items() if k != "max_abs"},
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

    # == The remaining fit stages and the GT-3D fit evaluations ============
    fit3d_records = {}
    for name, path in FIT3D_RECORDS.items():
        with open(os.path.join(root, path)) as f:
            fit3d_records[name] = json.load(f)
    knobs = FitConfig(proxy_wh=FIT3D_WH, render_wh=FIT_RENDER_WH,
                      **FIT3D_KNOBS)
    # The first batch of the multi-view and the track evaluations, drawn
    # as they draw it.
    mv_draws0 = fit3d.sample_multiview_eval_draws(
        torch.Generator().manual_seed(FIT3D_SEEDS["multiview"]), MV_BATCH,
        MV_VIEWS, FIT3D_WH)
    tr_draws0 = fit3d.sample_track_eval_draws(
        torch.Generator().manual_seed(FIT3D_SEEDS["track"]), TRACK_BATCH,
        TRACK_FRAMES, FIT3D_WH)
    mv_scene0 = scenes.synth_scene_views(assets, mv_draws0.scene,
                                         wh=FIT3D_WH)
    tr_scene0 = scenes.synth_track_views(assets, tr_draws0.track,
                                         wh=FIT3D_WH)

    def rows_verts2d(body_pose, orient, betas, cam, wh):
        """(R, V, 2) vertices of R fit rows as the fit renders them: in
        the evaluations' FIT3D_WH^2 proxy frame, scaled to the wh^2
        render."""
        with torch.no_grad():
            v2d = scenes.view_geometry(assets, body_pose, orient, betas, cam,
                                       FIT3D_WH)["verts2d"]
        return (v2d * (wh / FIT3D_WH)).contiguous()

    def flat2(x):
        return x.reshape((-1,) + tuple(x.shape[2:]))

    # -- fit_views_parity: K1/K2 at the new fits' row counts -----------------
    # The multi-view rows (8 players x 3 views) and the track rows (4 x 8)
    # at their generating parameters, the track bench's 11 x 4 at its init;
    # 256^2, sigma 1e-5. The plain versions (dense, ~0.6 s a row for K2)
    # run on the first K12_PLAIN_B rows of the timed launch.
    t = time.time()
    views0 = mv_scene0["views"]
    mv_rows = (mv_scene0["scene"]["body_pose"].repeat_interleave(
                   MV_VIEWS, dim=0),
               flat2(torch.stack([v["global_orient"] for v in views0], 1)),
               mv_scene0["scene"]["betas"].repeat_interleave(MV_VIEWS, dim=0),
               flat2(torch.stack([v["cam_wp"] for v in views0], 1)))
    tr_rows = (flat2(tr_scene0["body_pose"]), flat2(tr_scene0["global_orient"]),
               tr_scene0["betas"].repeat_interleave(TRACK_FRAMES, dim=0),
               flat2(tr_scene0["cam_wp"]))
    new_k12 = [
        dict(k12_case(rows_verts2d(*mv_rows, FIT_RENDER_WH), FIT_RENDER_WH,
                      K12_PLAIN_B), path="fit3d_mv_eval"),
        dict(k12_case(rows_verts2d(*tr_rows, FIT_RENDER_WH), FIT_RENDER_WH,
                      K12_PLAIN_B), path="fit3d_track_eval"),
        dict(k12_case(posed_verts2d(BENCH_TRACK_PLAYERS * BENCH_TRACK_FRAMES,
                                    FIT_RENDER_WH), FIT_RENDER_WH,
                      K12_PLAIN_B), path="track_bench")]
    check([r["b"] for r in new_k12] == [
        MV_BATCH * MV_VIEWS, TRACK_BATCH * TRACK_FRAMES,
        BENCH_TRACK_PLAYERS * BENCH_TRACK_FRAMES],
        "the new fit shapes are %s rows" % [r["b"] for r in new_k12])
    emit("fit_views_parity", t, k1_tol=K1_TOL, k2_tol=K2_TOL,
         shapes=[{k: v for k, v in r.items() if k != "max_abs"}
                 for r in new_k12], nvidia_smi=smi)
    k12 += new_k12

    # -- k3_scene_parity: K3 at the scene renders' 512^2 pass ----------------
    # One view of 8 players (no occluder) and the track batch (4 players x
    # 8 frames), as render_view z-buffers them; bit-equal to the dense
    # plain version on the first 2 images of the timed launch.
    t = time.time()
    k3_scenes = []
    for path, rows in (("fit3d_mv_eval", tuple(
            x.reshape((MV_BATCH, MV_VIEWS) + tuple(x.shape[1:]))[:, 0]
            for x in mv_rows)), ("fit3d_track_eval", tr_rows)):
        geo = scenes.view_geometry(assets, *rows, FIT3D_WH)
        scn = {"verts2d": geo["verts2d"], "verts_z": geo["verts_z"],
               "faces": assets.faces}
        k3_scenes.append(dict(k3_case(scn, rows[0].shape[0], FIT3D_WH, 1.0,
                                      K3_SCENE_PLAIN_B), path=path))
    check([r["b"] for r in k3_scenes] == [MV_BATCH,
                                          TRACK_BATCH * TRACK_FRAMES],
          "the scene passes hold %s images" % [r["b"] for r in k3_scenes])
    emit("k3_scene_parity", t, flops_per_pair=K3_FLOPS_PER_PAIR,
         shapes=k3_scenes, launches_per_path_pass=1, nvidia_smi=smi)
    k3 += k3_scenes

    def counted(fn):
        """``fn()`` with every kernel's count set to 0 just before it:
        (its result, wall s, K1/K2 launches, K3 launches)."""
        torch.cuda.synchronize()
        br.reset_launch_counts()
        zb.reset_launch_counts()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return (out, time.time() - t0, dict(br.LAUNCHES),
                zb.LAUNCHES["zbuffer_bary"])

    def hold_to_record(res, record, arms, what):
        """Each arm's MPJPE-PA and PVE-PA within RECORD_REL of the
        committed record; returns {metric: [value, record]}."""
        out = {}
        for arm in arms:
            for m in ("mpjpe_pa_mm", "pve_pa_mm"):
                k = "%s_%s" % (arm, m)
                check(np.isfinite(res[k]), "%s: %s is not finite" % (what, k))
                check(abs(res[k] - record[k]) <= RECORD_REL * record[k],
                      "%s %s %.2f is not within %d%% of the record %.2f"
                      % (what, k, res[k], RECORD_REL * 100, record[k]))
                out[k] = [res[k], record[k]]
        return out

    k3_fit_launches = {}

    # -- fit3d_eval: the single-view fit against the generating 3-D ----------
    # Each batch's metrics are recorded as the evaluation computes them
    # (init, then fit), so the fit's effect on MPJPE-PA comes with its
    # spread over the batches.
    t = time.time()
    batch_metrics = []
    metrics_float = straps.metrics_float

    def recording_metrics(*args):
        out = metrics_float(*args)
        batch_metrics.append(out)
        return out

    straps.metrics_float = recording_metrics
    try:
        res_sv, sv_s, sv_k12, sv_k3 = counted(
            lambda: straps.evaluate_fit_3d(
                model, assets, n_batches=SV_BATCHES, batch=SV_BATCH,
                wh=FIT3D_WH, fit_cfg=knobs, seed=FIT3D_SEEDS["single"],
                device=dev))
    finally:
        straps.metrics_float = metrics_float
    check(len(batch_metrics) == 2 * SV_BATCHES,
          "fit3d_eval computed %d metric sets" % len(batch_metrics))
    per_batch = [[m["mpjpe_pa_mm"] for m in batch_metrics[b::2]]
                 for b in (0, 1)]
    rise = np.array(per_batch[1]) - np.array(per_batch[0])
    check(abs(float(np.mean(per_batch[0])) - res_sv["init_mpjpe_pa_mm"])
          <= 1e-3 * res_sv["init_mpjpe_pa_mm"],
          "the recorded batches do not average to the evaluation's result")
    iters = FIT3D_KNOBS["iters"]
    check(sv_k12 == {"band_raster_fwd": SV_BATCHES * iters,
                     "band_raster_bwd": SV_BATCHES * iters},
          "fit3d_eval launched K1/K2 %s times" % sv_k12)
    check(sv_k3 == 2 * SV_BATCHES, "fit3d_eval launched K3 %d times"
          % sv_k3)
    held = hold_to_record(res_sv, fit3d_records["single"], ("init", "fit"),
                          "fit3d_eval")
    k12_launches["fit3d_eval"] = sv_k12
    k3_fit_launches["fit3d_eval"] = sv_k3
    emit("fit3d_eval", t, n_images=res_sv["n_images"], wh=FIT3D_WH,
         render_wh=FIT_RENDER_WH, iters=iters, fit_knobs=FIT3D_KNOBS,
         wall_s=round(sv_s, 4), players_per_s=round(res_sv["n_images"]
                                                    / sv_s, 3),
         k1_k2_launches=sv_k12, k3_launches=sv_k3, held_to_record=held,
         record=FIT3D_RECORDS["single"], record_rel_tol=RECORD_REL,
         metrics=res_sv, per_batch_mpjpe_pa_mm={
             "init": per_batch[0], "fit": per_batch[1],
             "fit_minus_init": rise.tolist(),
             "fit_minus_init_mean": float(rise.mean()),
             "fit_minus_init_std": float(rise.std(ddof=1)),
             "fit_minus_init_sem": float(rise.std(ddof=1)
                                         / np.sqrt(len(rise)))},
         profile_note="one batch, %d iterations"
         % PROFILE_ITERS, profile=device_profile(
             lambda: straps.evaluate_fit_3d(
                 model, assets, n_batches=1, batch=SV_BATCH, wh=FIT3D_WH,
                 fit_cfg=dataclasses.replace(knobs, iters=PROFILE_ITERS),
                 seed=FIT3D_SEEDS["single"], device=dev)),
         nvidia_smi=smi)

    # -- fit3d_mv_eval: init vs single-view vs multi-view --------------------
    t = time.time()
    res_mv, mv_s, mv_k12, mv_k3 = counted(
        lambda: fit3d.evaluate_fit_3d_multiview(
            model, assets, n_batches=FIT3D_BATCHES, batch=MV_BATCH,
            n_views=MV_VIEWS, wh=FIT3D_WH, fit_cfg=knobs, rounds=MV_ROUNDS,
            iters_per_phase=MV_ITERS, seed=FIT3D_SEEDS["multiview"],
            device=dev))
    # Per batch: the 100-iteration single-view arm, 3 rounds of 50 + 50,
    # and one forward-only evaluation of the final parameters (K1 alone).
    mv_iters = iters + MV_ROUNDS * 2 * MV_ITERS
    check(mv_k12 == {"band_raster_fwd": FIT3D_BATCHES * (mv_iters + 1),
                     "band_raster_bwd": FIT3D_BATCHES * mv_iters},
          "fit3d_mv_eval launched K1/K2 %s times" % mv_k12)
    check(mv_k3 == FIT3D_BATCHES * MV_VIEWS,
          "fit3d_mv_eval launched K3 %d times" % mv_k3)
    held = hold_to_record(res_mv, fit3d_records["multiview"],
                          ("init", "sv", "mv"), "fit3d_mv_eval")
    check(res_mv["mv_mpjpe_pa_mm"] < res_mv["init_mpjpe_pa_mm"],
          "the multi-view fit does not lower MPJPE-PA: %.2f vs init %.2f"
          % (res_mv["mv_mpjpe_pa_mm"], res_mv["init_mpjpe_pa_mm"]))
    k12_launches["fit3d_mv_eval"] = mv_k12
    k3_fit_launches["fit3d_mv_eval"] = mv_k3
    emit("fit3d_mv_eval", t, n_players=res_mv["n_players"],
         n_views=MV_VIEWS, wh=FIT3D_WH, render_wh=FIT_RENDER_WH,
         rounds=MV_ROUNDS, iters_per_phase=MV_ITERS, sv_iters=iters,
         wall_s=round(mv_s, 4),
         players_per_s=round(res_mv["n_players"] / mv_s, 3),
         k1_k2_launches=mv_k12, k3_launches=mv_k3, held_to_record=held,
         record=FIT3D_RECORDS["multiview"], record_rel_tol=RECORD_REL,
         metrics={k: v for k, v in res_mv.items() if k != "note"},
         profile_note="one batch, %d single-view iterations, 1 round of "
         "%d + %d" % (PROFILE_ITERS, PROFILE_ITERS, PROFILE_ITERS),
         profile=device_profile(lambda: fit3d.evaluate_fit_3d_multiview(
             model, assets, n_batches=1, batch=MV_BATCH, n_views=MV_VIEWS,
             wh=FIT3D_WH, fit_cfg=dataclasses.replace(
                 knobs, iters=PROFILE_ITERS), rounds=1,
             iters_per_phase=PROFILE_ITERS, seed=FIT3D_SEEDS["multiview"],
             device=dev)),
         nvidia_smi=smi)

    # -- fit3d_track_eval: init vs the shared-betas track fit ----------------
    t = time.time()
    res_tr, tr_s, tr_k12, tr_k3 = counted(
        lambda: fit3d.evaluate_fit_3d_track(
            model, assets, n_batches=FIT3D_BATCHES, batch=TRACK_BATCH,
            n_frames=TRACK_FRAMES, wh=FIT3D_WH, fit_cfg=knobs,
            seed=FIT3D_SEEDS["track"], device=dev))
    check(tr_k12 == {"band_raster_fwd": FIT3D_BATCHES * iters,
                     "band_raster_bwd": FIT3D_BATCHES * iters},
          "fit3d_track_eval launched K1/K2 %s times" % tr_k12)
    check(tr_k3 == FIT3D_BATCHES, "fit3d_track_eval launched K3 %d times"
          % tr_k3)
    held = hold_to_record(res_tr, fit3d_records["track"], ("init", "fit"),
                          "fit3d_track_eval")
    k12_launches["fit3d_track_eval"] = tr_k12
    k3_fit_launches["fit3d_track_eval"] = tr_k3
    emit("fit3d_track_eval", t, n_players=res_tr["n_players"],
         n_frames=TRACK_FRAMES, wh=FIT3D_WH, render_wh=FIT_RENDER_WH,
         iters=iters, wall_s=round(tr_s, 4),
         players_per_s=round(res_tr["n_players"] / tr_s, 3),
         k1_k2_launches=tr_k12, k3_launches=tr_k3, held_to_record=held,
         record=FIT3D_RECORDS["track"], record_rel_tol=RECORD_REL,
         metrics={k: v for k, v in res_tr.items() if k != "note"},
         profile_note="one batch, %d iterations" % PROFILE_ITERS,
         profile=device_profile(lambda: fit3d.evaluate_fit_3d_track(
             model, assets, n_batches=1, batch=TRACK_BATCH,
             n_frames=TRACK_FRAMES, wh=FIT3D_WH,
             fit_cfg=dataclasses.replace(knobs, iters=PROFILE_ITERS),
             seed=FIT3D_SEEDS["track"], device=dev)),
         nvidia_smi=smi)

    # -- broad_fit: the broadcast view, pose and shape from the multi-view ---
    # One scene of 8 players, 3 narrow views and the broad one (clean
    # observations, scores 1); the multi-view fit from the regressor's
    # per-view init gives the pose and betas, the regressor on the broad
    # crop the orient and camera; broad_view_fit at the stage's lr 0.01 for
    # its 100 iterations, 256^2 render.
    t = time.time()
    b_draws = scenes.sample_scene_views_draws(
        torch.Generator().manual_seed(BROAD_SEED), MV_BATCH, MV_VIEWS)
    (b_scene, _, _, b_k3) = counted(lambda: scenes.synth_scene_views(
        assets, b_draws, wh=FIT3D_WH))
    check(b_k3 == MV_VIEWS + 1, "the broad scene launched K3 %d times"
          % b_k3)

    def scored(j2d):
        return torch.cat([j2d, torch.ones_like(j2d[..., :1])], dim=-1)

    b_sil = torch.stack([v["silhouette"] for v in b_scene["views"]], 1)
    b_j2d = scored(torch.stack([v["joints2d"] for v in b_scene["views"]], 1))
    cam_f, rot_f, betas_f = straps.infer_rotmats(
        model, assets, create_proxy_representation(
            flat2(b_sil), flat2(b_j2d)[..., :2], in_wh=FIT3D_WH))
    rot_v = rot_f.reshape(MV_BATCH, MV_VIEWS, 24, 3, 3)
    mv_res, mv_fit_s, b_mv_k12, _ = counted(lambda: multi_view_fit(
        assets, MultiViewInit(rot_v[:, :, 1:], rot_v[:, :, :1],
                              betas_f.reshape(MV_BATCH, MV_VIEWS, 10),
                              cam_f.reshape(MV_BATCH, MV_VIEWS, 3)),
        b_sil, b_j2d, knobs, rounds=MV_ROUNDS, iters_per_phase=MV_ITERS,
        device=dev))
    broad = b_scene["broad"]
    b_cam, b_rot, _ = straps.infer_rotmats(
        model, assets, create_proxy_representation(
            broad["silhouette"], broad["joints2d"], in_wh=FIT3D_WH))
    broad_cfg = FitConfig(iters=cfg.BROAD_VIEW_ITERS, lr=cfg.BROAD_VIEW_LR,
                          proxy_wh=FIT3D_WH, render_wh=FIT_RENDER_WH)
    b_res, broad_s, b_k12, _ = counted(lambda: broad_view_fit(
        assets, mv_res.body_pose, mv_res.betas, b_rot[:, :1], b_cam,
        broad["silhouette"], scored(broad["joints2d"]), broad_cfg,
        device=dev))
    check(torch.equal(b_res.body_pose, mv_res.body_pose)
          and torch.equal(b_res.betas, mv_res.betas),
          "broad_view_fit changed the pose or the betas")
    check(b_k12 == {"band_raster_fwd": cfg.BROAD_VIEW_ITERS,
                    "band_raster_bwd": cfg.BROAD_VIEW_ITERS},
          "broad_view_fit launched K1/K2 %s times" % b_k12)
    for name in ("silh_iou", "joint_err", "init_silh_iou", "init_joint_err",
                 "global_orient", "cam_wp"):
        check(bool(torch.isfinite(getattr(b_res, name)).all()),
              "broad_view_fit: %s is not finite" % name)
    k12_launches["broad_fit"] = {k: b_mv_k12[k] + b_k12[k] for k in b_k12}
    k3_fit_launches["broad_fit"] = b_k3
    emit("broad_fit", t, players=MV_BATCH, views=MV_VIEWS, wh=FIT3D_WH,
         render_wh=FIT_RENDER_WH, iters=cfg.BROAD_VIEW_ITERS,
         lr=cfg.BROAD_VIEW_LR, wall_s=round(broad_s, 4),
         multi_view_wall_s=round(mv_fit_s, 4),
         init_iou=float(b_res.init_silh_iou.mean()),
         best_iou=float(b_res.silh_iou.mean()),
         init_joint_err=float(b_res.init_joint_err.mean()),
         best_joint_err=float(b_res.joint_err.mean()),
         best_iter_mean=float(b_res.best_iter.float().mean()),
         multi_view_iou=float(mv_res.silh_iou.mean()),
         multi_view_joint_err=float(mv_res.joint_err.mean()),
         pose_betas_unchanged=True, k1_k2_launches={
             "multi_view_fit": b_mv_k12, "broad_view_fit": b_k12},
         k3_launches=b_k3, nvidia_smi=smi)

    # -- track_bench: bench.py:bench_track's shape, warm ---------------------
    t = time.time()
    n_b, n_t = BENCH_TRACK_PLAYERS, BENCH_TRACK_FRAMES
    aa, betas, cam, sil, j2d = bench_scene(n_b * n_t)
    rot = batch_rodrigues(torch.from_numpy(aa)).reshape(n_b, n_t, 24, 3, 3)
    tb_init = TrackInit(rot[:, :, 1:], rot[:, :, :1],
                        torch.from_numpy(betas).reshape(n_b, n_t, 10),
                        torch.from_numpy(cam).reshape(n_b, n_t, 3))
    tb_sil = torch.from_numpy(sil).reshape(n_b, n_t, PROXY_WH, PROXY_WH)
    tb_j2d = torch.from_numpy(j2d).reshape(n_b, n_t, 17, 2)
    track_fit(assets, tb_init, tb_sil, tb_j2d,
              FitConfig(iters=2, render_wh=FIT_RENDER_WH), device=dev)
    tb_res, tb_s, tb_k12, _ = counted(lambda: track_fit(
        assets, tb_init, tb_sil, tb_j2d,
        FitConfig(iters=BENCH_TRACK_ITERS, render_wh=FIT_RENDER_WH),
        device=dev))
    check(tb_k12 == {"band_raster_fwd": BENCH_TRACK_ITERS,
                     "band_raster_bwd": BENCH_TRACK_ITERS},
          "the track bench launched K1/K2 %s times" % tb_k12)
    for name, shape in (("betas", (n_b, 10)), ("silh_iou", (n_b,)),
                        ("joint_err", (n_b,)),
                        ("body_pose", (n_b, n_t, 23, 3, 3))):
        v = getattr(tb_res, name)
        check(tuple(v.shape) == shape and bool(torch.isfinite(v).all()),
              "track bench: %s is %s, not finite %s" % (name,
                                                        tuple(v.shape),
                                                        shape))
    k12_launches["track_bench"] = tb_k12
    emit("track_bench", t, players=n_b, frames=n_t, rows=n_b * n_t,
         proxy_wh=PROXY_WH, render_wh=FIT_RENDER_WH,
         iters=BENCH_TRACK_ITERS, wall_s=round(tb_s, 4),
         players_per_s=round(n_b / tb_s, 3),
         player_frames_per_s=round(n_b * n_t / tb_s, 2),
         ms_per_iter=round(tb_s / BENCH_TRACK_ITERS * 1e3, 3),
         best_iou=float(tb_res.silh_iou.mean()),
         best_joint_err=float(tb_res.joint_err.mean()),
         k1_k2_launches=tb_k12, profile_note="%d iterations"
         % PROFILE_ITERS, profile=device_profile(lambda: track_fit(
             assets, tb_init, tb_sil, tb_j2d,
             FitConfig(iters=PROFILE_ITERS, render_wh=FIT_RENDER_WH),
             device=dev)), nvidia_smi=smi)

    # == The folder-tree stages, their IO and the command line ==============
    with open(os.path.join(root, MINT_RECORD)) as f:
        mint = json.load(f)
    if 512 not in pn_nets:
        pn_nets[512] = load_proxynet_weights(
            os.path.join(root, PN_WEIGHTS[512]), dev)

    def regressor_fn(assets_, silhouette, joints2d):
        return predict_smpl(model, assets_, silhouette, joints2d, device=dev)

    def scene_spread(scene_of_row, values):
        """Per-scene means of one metric and their spread."""
        by = {}
        for s_name, v in zip(scene_of_row, values):
            by.setdefault(s_name, []).append(v)
        means = {k: float(np.mean(v)) for k, v in sorted(by.items())}
        arr = np.array(list(means.values()))
        return {"per_scene": means, "min": float(arr.min()),
                "max": float(arr.max()), "std": float(arr.std(ddof=1))
                if len(arr) > 1 else 0.0}

    def hold_mint(stage, got, keys):
        """Each mean within RECORD_REL of the mint record."""
        out = {}
        for k in keys:
            rec = mint[stage][k]
            check(np.isfinite(got[k]) and abs(got[k] - rec)
                  <= RECORD_REL * abs(rec),
                  "stage_chain %s %s %.4f is not within %d%% of the mint "
                  "record %.4f" % (stage, k, got[k], RECORD_REL * 100, rec))
            out[k] = [got[k], rec]
        return out

    env = dict(os.environ, PYTHONPATH=root)

    def cli(*args):
        """One CLI subcommand as a subprocess on the card: (its last JSON
        line, wall s)."""
        t_c = time.time()
        child = subprocess.Popen(
            [sys.executable, "-m", "soccerplayershapepose_torch", *args],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        _CHILDREN.append(child)
        try:
            out, err = child.communicate(timeout=CLI_TIMEOUT_S)
        finally:
            child.kill()
            child.wait()
            _CHILDREN.remove(child)
        check(child.returncode == 0, "the CLI's %s exited %d: %s"
              % (args[0], child.returncode, err[-2000:]))
        return (json.loads(out.strip().splitlines()[-1]),
                round(time.time() - t_c, 3))

    def tree_phases(work: str):
        """The new phases, on trees written under ``work``: returns the
        K1/K2 and K3 launches by path and the new K1/K2 and K3 shapes."""
        k12_paths, k3_paths, k12_new, k3_new = {}, {}, [], []
        tree = os.path.join(work, "mint")
        d = {k: os.path.join(tree, k) for k in (
            "images", "proxies", "broad_images", "broad_proxies", "sgl",
            "mul", "broad", "sgl_default", "vis_default")}
        n_views = TREE_SCENES * TREE_PLAYERS * TREE_VIEWS
        n_players = TREE_SCENES * TREE_PLAYERS
        one = os.path.join(work, "one_scene")
        o = {k: os.path.join(one, k) for k in (
            "images", "proxies", "broad_images", "broad_proxies", "sgl",
            "mul", "broad")}

        # -- tree_write: the scene factory and the tree writer ------------
        t = time.time()
        gen = torch.Generator().manual_seed(TREE_SEED)
        corr_gen = torch.Generator().manual_seed(TREE_SEED + 1)
        written = []

        def write_tree():
            for s in range(TREE_SCENES):
                draws = scenes.sample_scene_views_draws(gen, TREE_PLAYERS,
                                                        TREE_VIEWS)
                data = scenes.synth_scene_views(assets, draws, wh=TREE_WH)
                corr = scenes.sample_tree_corruption(corr_gen, data)
                scenes.write_scene_tree(tree, "game0", "scene%d" % s, data,
                                        corruption=corr, write_images=False)
                written.append((data, corr))

        _, tw_s, _, tw_k3 = counted(write_tree)
        n_files = sum(len(f) for _, _, f in os.walk(tree))
        n_bytes = sum(os.path.getsize(os.path.join(p, f))
                      for p, _, fs in os.walk(tree) for f in fs)
        check(tw_k3 == TREE_SCENES * (TREE_VIEWS + 1),
              "the tree's scenes launched K3 %d times" % tw_k3)
        check(n_files == TREE_SCENES * (TREE_PLAYERS * (TREE_VIEWS + 1) * 3
                                        + TREE_PLAYERS + 3),
              "the tree holds %d files" % n_files)
        # The native dataplane (or its Python path) reads the same tree.
        sils = native.scan_tree(tree, "_sil.npy")
        check(len(sils) == n_players * (TREE_VIEWS + 1),
              "scan_tree found %d silhouettes" % len(sils))
        stems = [os.path.join(tree, p[:-len("_sil.npy")]) for p in sils[:4]]
        n_sil, n_j2d = native.load_proxy_batch(stems, wh=TREE_WH)
        for i, stem in enumerate(stems):
            s_i, j_i = stages.load_proxy_batch(os.path.dirname(stem),
                                               [os.path.basename(stem)])
            check(np.array_equal(n_sil[i], s_i[0])
                  and np.abs(n_j2d[i] - j_i[0]).max() <= 1e-4,
                  "the dataplane's proxy %s differs from np.load's" % stem)
        # Scene 0 again, alone: the tree of the command line and of the
        # profiled short runs (fewer batches, so the profiler's trace stays
        # short).
        data0, corr0 = written[0]
        scenes.write_scene_tree(one, "game0", "scene0", data0,
                                corruption=corr0, write_images=False)
        # K3 at the tree's pass: one narrow view of TREE_PLAYERS bodies.
        view0 = data0["views"][0]
        geo = scenes.view_geometry(assets, data0["scene"]["body_pose"],
                                   view0["global_orient"],
                                   data0["scene"]["betas"], view0["cam_wp"],
                                   TREE_WH)
        k3_new.append(dict(k3_case(
            {"verts2d": geo["verts2d"], "verts_z": geo["verts_z"],
             "faces": assets.faces}, TREE_PLAYERS, TREE_WH, 1.0,
            K3_SCENE_PLAIN_B), path="tree_write"))
        k3_paths["tree_write"] = tw_k3
        emit("tree_write", t, seed=TREE_SEED, games=1, scenes=TREE_SCENES,
             players=TREE_PLAYERS, views=TREE_VIEWS, broad_view=True,
             wh=TREE_WH, reduced_from_games=8, view_crops=n_views,
             wall_s=round(tw_s, 4), files=n_files, bytes=n_bytes,
             k3_launches=tw_k3, native_dataplane=native.native_available(),
             k3_tree_view=k3_new[-1], nvidia_smi=smi)

        # -- stage_chain: the mint yardstick on that tree --------------------
        t = time.time()
        sv_cfg = FitConfig(iters=cfg.SINGLE_VIEW_ITERS, **MINT_KNOBS)
        mv_cfg = FitConfig(iters=cfg.MULTI_VIEW_ITERS, **MINT_KNOBS)
        bv_cfg = FitConfig(iters=cfg.BROAD_VIEW_ITERS,
                           **dict(MINT_KNOBS, lr=cfg.BROAD_VIEW_LR))
        rows = {"single": [], "broad": []}
        sv_fit, bv_fit = stages.single_view_fit, stages.broad_view_fit

        def keep_rows(name, res, mask):
            keep = mask.bool().cpu()
            rows[name] += zip(*(x.cpu()[keep].tolist() for x in (
                res.init_silh_iou, res.init_joint_err, res.silh_iou,
                res.joint_err)))
            return res

        def record_single(a, init, sil, j2d, fit_cfg, mask, **kw):
            return keep_rows("single", sv_fit(a, init, sil, j2d, fit_cfg,
                                              mask, **kw), mask)

        def record_broad(a, bp, be, orient, cam, sil, j2d, fit_cfg, mask,
                         **kw):
            return keep_rows("broad", bv_fit(a, bp, be, orient, cam, sil,
                                             j2d, fit_cfg, mask, **kw), mask)

        stages.single_view_fit, stages.broad_view_fit = (record_single,
                                                         record_broad)
        try:
            sv, sv_s, sv_k12, _ = counted(
                lambda: stages.single_view_optimization(
                    assets, d["images"], d["proxies"], d["sgl"],
                    regressor_fn=regressor_fn, fit_cfg=sv_cfg,
                    batch_size=MINT_BATCH, verbose=False, device=dev))
            mv, mv_s, mv_k12, _ = counted(
                lambda: stages.multi_view_optimization(
                    assets, d["images"], d["proxies"], d["sgl"], d["mul"],
                    fit_cfg=mv_cfg, batch_size=MINT_MV_BATCH, verbose=False,
                    device=dev))
            bv, bv_s, bv_k12, _ = counted(
                lambda: stages.broad_view_optimization(
                    assets, d["broad_images"], d["broad_proxies"], d["mul"],
                    d["broad"], regressor_fn=regressor_fn, fit_cfg=bv_cfg,
                    batch_size=MINT_BATCH, verbose=False, device=dev))
        finally:
            stages.single_view_fit, stages.broad_view_fit = sv_fit, bv_fit
        ci, ci_s, ci_k12, _ = counted(lambda: stages.calc_initial_metrics(
            assets, d["images"], d["proxies"], d["sgl"], fit_cfg=sv_cfg,
            batch_size=MINT_BATCH, device=dev))
        bv_tree = io_formats.calc_metrics(d["broad"])
        sv_b = -(-n_views // MINT_BATCH)
        mv_b = -(-n_players // MINT_MV_BATCH)
        bv_b = -(-n_players // MINT_BATCH)
        sv_it = sv_b * cfg.SINGLE_VIEW_ITERS
        mv_it = mv_b * cfg.MULTI_VIEW_ROUNDS * 2 * cfg.MULTI_VIEW_ITERS
        bv_it = bv_b * cfg.BROAD_VIEW_ITERS
        for what, got, want in (
                ("single-view", sv_k12, (sv_it, sv_it)),
                ("multi-view", mv_k12, (mv_it + mv_b, mv_it)),
                ("broad-view", bv_k12, (bv_it, bv_it)),
                ("calc_initial_metrics", ci_k12, (sv_b, 0))):
            check((got["band_raster_fwd"], got["band_raster_bwd"]) == want,
                  "the %s stage launched K1/K2 %s times, not %s"
                  % (what, got, want))
        check(sv["count"] == n_views and mv["count"] == n_players
              and bv["count"] == n_players and ci["count"] == n_views,
              "stage counts %s" % [sv["count"], mv["count"], bv["count"],
                                   ci["count"]])
        held = {"single": hold_mint("single", sv, ("init_iou", "init_err",
                                                   "opt_iou", "opt_err")),
                "multi": hold_mint("multi", mv, ("iou", "err")),
                "broad": hold_mint("broad", bv, ("init_iou", "init_err",
                                                 "opt_iou", "opt_err"))}
        for stage, r in (("single", sv), ("broad", bv)):
            check(r["opt_iou"] > r["init_iou"] and r["opt_err"] < r["init_err"],
                  "the %s fit does not improve IoU and joint error: %s"
                  % (stage, r))
        # The stored results reproduce the stage's own metrics.
        check(abs(ci["silh_iou"] - sv["opt_iou"]) <= 1e-2 * sv["opt_iou"]
              and abs(ci["joint_err"] - sv["opt_err"])
              <= 1e-2 * sv["opt_err"],
              "calc_initial_metrics %s vs the stage's %s" % (ci, sv))
        check(abs(bv_tree["mean_silh_iou"] - bv["opt_iou"]) <= 1e-9
              and abs(bv_tree["mean_joint_err"] - bv["opt_err"]) <= 1e-9
              and bv_tree["num_players"] == n_players,
              "calc_metrics on the broad tree %s vs the stage's %s"
              % (bv_tree, bv))
        sv_scene = [n.scene for n, _ in stages._gather_views(
            d["images"], d["proxies"], True)]
        bv_scene = [n.scene for n in io_formats.walk_player_tree(
            d["broad_images"])]
        mv_nodes = list(io_formats.walk_player_tree(d["mul"],
                                                    view_suffix=".xml"))
        mv_metrics = [io_formats.read_metrics(os.path.join(
            n.path, "metrics.xml")) for n in mv_nodes]
        check(len(rows["single"]) == len(sv_scene) == n_views
              and len(rows["broad"]) == len(bv_scene) == n_players,
              "recorded %d / %d rows" % (len(rows["single"]),
                                         len(rows["broad"])))
        names = ("init_iou", "init_err", "opt_iou", "opt_err")
        spread = {
            "single": {k: scene_spread(sv_scene, [r[i] for r in
                                                  rows["single"]])
                       for i, k in enumerate(names)},
            "multi": {k: scene_spread([n.scene for n in mv_nodes],
                                      [m[i] for m in mv_metrics])
                      for i, k in enumerate(("iou", "err"))},
            "broad": {k: scene_spread(bv_scene, [r[i] for r in
                                                 rows["broad"]])
                      for i, k in enumerate(names)}}
        # Idle shares from short runs on the one-scene tree (the
        # multi-view and broadcast runs start from this chain's results).
        prof_root = os.path.join(work, "profile")
        profiles = {
            "single": device_profile(lambda: stages.single_view_optimization(
                assets, o["images"], o["proxies"], prof_root + "_sv",
                regressor_fn=regressor_fn, fit_cfg=dataclasses.replace(
                    sv_cfg, iters=PROFILE_ITERS), batch_size=MINT_BATCH,
                verbose=False, device=dev)),
            "multi": device_profile(lambda: stages.multi_view_optimization(
                assets, o["images"], o["proxies"], d["sgl"],
                prof_root + "_mv", fit_cfg=mv_cfg, batch_size=MINT_MV_BATCH,
                rounds=1, iters_per_phase=PROFILE_ITERS, verbose=False,
                device=dev)),
            "broad": device_profile(lambda: stages.broad_view_optimization(
                assets, o["broad_images"], o["broad_proxies"], d["mul"],
                prof_root + "_bv", regressor_fn=regressor_fn,
                fit_cfg=dataclasses.replace(bv_cfg, iters=PROFILE_ITERS),
                batch_size=MINT_BATCH, verbose=False, device=dev))}

        def timing(wall, iters, n, unit):
            return {"wall_s": round(wall, 4),
                    unit + "_per_s": round(n / wall, 3),
                    "iterations": iters,
                    "ms_per_iter": round(wall / iters * 1e3, 3)}

        k12_paths["stage_chain"] = {
            k: sv_k12[k] + mv_k12[k] + bv_k12[k] + ci_k12[k] for k in sv_k12}
        emit("stage_chain", t, record=MINT_RECORD, record_rel_tol=RECORD_REL,
             fit_knobs=MINT_KNOBS, batch=MINT_BATCH,
             multi_view_batch=MINT_MV_BATCH,
             single=dict(sv, **timing(sv_s, sv_it, n_views, "views"),
                         k1_k2_launches=sv_k12),
             multi=dict(mv, **timing(mv_s, mv_it, n_players, "players"),
                        k1_k2_launches=mv_k12),
             broad=dict(bv, **timing(bv_s, bv_it, n_players, "players"),
                        k1_k2_launches=bv_k12),
             calc_initial_metrics=dict(ci, wall_s=round(ci_s, 4),
                                       k1_k2_launches=ci_k12),
             calc_metrics_broad=bv_tree, held_to_record=held,
             per_scene_spread=spread,
             profile_note="one scene, %d iterations a batch (multi-view: "
             "1 round of %d + %d)" % (PROFILE_ITERS, PROFILE_ITERS,
                                      PROFILE_ITERS),
             profiles=profiles, nvidia_smi=smi)

        # -- stage_default: the single-view stage at its own defaults --------
        # Run once on the tree without the overlays (the fits'
        # throughput), then on its first OVERLAY_VIEWS views (in the
        # stage's order) with them, as the stage's vis_folder writes them,
        # timing the overlay's render and its PNG encode where they run.
        t = time.time()
        sub = os.path.join(tree, "overlay_views")
        for node, view in stages._gather_views(
                d["images"], d["proxies"], True)[:OVERLAY_VIEWS]:
            rel = os.path.relpath(node.path, d["images"])
            stem = os.path.splitext(view)[0]
            for kind, names in (("images", [view]), ("proxies", [
                    stem + "_sil.npy", stem + "_j2d.xml"])):
                os.makedirs(os.path.join(sub, kind, rel), exist_ok=True)
                for name in names:
                    shutil.copy(os.path.join(d[kind], rel, name),
                                os.path.join(sub, kind, rel, name))
        runs, overlay_split = {}, {}
        real = {"render": vis_mod.render_mesh_overlay,
                "encode": io_formats.write_png}
        for name, root_, n_v, vis in (
                ("fits", tree, n_views, None),
                ("with_overlays", sub, OVERLAY_VIEWS, d["vis_default"])):
            vis_mod.render_mesh_overlay = timed(overlay_split, "render",
                                                real["render"])
            io_formats.write_png = timed(overlay_split, "png_encode",
                                         real["encode"])
            try:
                runs[name] = counted(
                    lambda: stages.single_view_optimization(
                        assets, os.path.join(root_, "images"),
                        os.path.join(root_, "proxies"),
                        d["sgl_default"] + "_" + name,
                        regressor_fn=regressor_fn, batch_size=STAGE_BATCH,
                        vis_folder=vis, verbose=False, device=dev))
            finally:
                vis_mod.render_mesh_overlay = real["render"]
                io_formats.write_png = real["encode"]
            res_d, _, k12_d, _ = runs[name]
            it = -(-n_v // STAGE_BATCH) * cfg.SINGLE_VIEW_ITERS
            check(k12_d == {"band_raster_fwd": it, "band_raster_bwd": it},
                  "the default stage launched K1/K2 %s times" % k12_d)
            check(res_d["count"] == n_v and all(np.isfinite(v)
                                                for v in res_d.values()),
                  "the default stage gave %s" % res_d)
        df_it = -(-n_views // STAGE_BATCH) * cfg.SINGLE_VIEW_ITERS
        ov_it = -(-OVERLAY_VIEWS // STAGE_BATCH) * cfg.SINGLE_VIEW_ITERS
        df, df_s, df_k12, _ = runs["with_overlays"]
        fits_s = runs["fits"][1]
        overlays = sorted(os.path.join(p, f) for p, _, fs in
                          os.walk(d["vis_default"]) for f in fs)
        check(len(overlays) == OVERLAY_VIEWS, "%d overlays" % len(overlays))
        with open(overlays[0], "rb") as f:
            overlay = decode_png(f.read())
        check(overlay.shape == (TREE_WH, TREE_WH, 3),
              "the overlay decodes to %s" % (overlay.shape,))
        # K1/K2 at the stage's shape: 32 rows of the tree's bodies (its
        # first 32 views, in the stage's order) rendered at 512^2.
        bp, go, be, cw = [], [], [], []
        for data, _ in written:
            for p in range(TREE_PLAYERS):
                for view in data["views"]:
                    bp.append(data["scene"]["body_pose"][p])
                    go.append(view["global_orient"][p])
                    be.append(data["scene"]["betas"][p])
                    cw.append(view["cam_wp"][p])
        rows32 = [torch.stack(x[:STAGE_BATCH]) for x in (bp, go, be, cw)]
        k12_new.append(dict(k12_case(rows_verts2d(*rows32, TREE_WH),
                                     TREE_WH, K12_DEFAULT_PLAIN_B),
                            path="stage_default"))
        k12_paths["stage_default"] = {
            k: sum(r[2][k] for r in runs.values()) for k in df_k12}
        emit("stage_default", t, batch=STAGE_BATCH, render_wh=TREE_WH,
             sigma=SIGMA, iters=cfg.SINGLE_VIEW_ITERS,
             metrics=runs["fits"][0],
             fits=timing(fits_s, df_it, n_views, "views"),
             overlay_views=OVERLAY_VIEWS, overlay_views_metrics=df,
             with_overlays=timing(df_s, ov_it, OVERLAY_VIEWS, "views"),
             overlay_ms_each=round(sum(overlay_split.values())
                                   / OVERLAY_VIEWS * 1e3, 3),
             overlay_split_ms_each={
                 k: round(v / OVERLAY_VIEWS * 1e3, 3)
                 for k, v in overlay_split.items()},
             k1_k2_launches_per_run={k: v[2] for k, v in runs.items()},
             overlays=len(overlays),
             overlay_shape=list(overlay.shape),
             kernels_at_shape={k: v for k, v in k12_new[-1].items()
                               if k != "max_abs"},
             profile_note="one scene, %d iterations, no overlays"
             % PROFILE_ITERS,
             profile=device_profile(lambda: stages.single_view_optimization(
                 assets, o["images"], o["proxies"],
                 os.path.join(work, "profile_default"),
                 regressor_fn=regressor_fn, batch_size=STAGE_BATCH,
                 fit_cfg=dataclasses.replace(FitConfig(),
                                             iters=PROFILE_ITERS),
                 verbose=False, device=dev)), nvidia_smi=smi)

        # -- create_proxy: RGB views, ProxyNet on the tree, predict ----------
        t = time.time()
        cp = os.path.join(work, "rgb")
        rgb_draws = scenes.sample_scene_views_draws(
            torch.Generator().manual_seed(CP_SEED), TREE_PLAYERS, TREE_VIEWS,
            image_wh=TREE_WH,
            image_gen=torch.Generator(device=dev).manual_seed(CP_SEED))
        rgb, _, _, cp_k3 = counted(lambda: scenes.synth_scene_views(
            assets, rgb_draws, wh=TREE_WH))
        check(cp_k3 == TREE_VIEWS + 1, "the RGB scene launched K3 %d times"
              % cp_k3)
        rv0 = rgb["views"][0]
        check(tuple(rv0["image"].shape) == (TREE_PLAYERS, TREE_WH, TREE_WH,
                                            3)
              and bool(torch.isfinite(rv0["image"]).all()),
              "the RGB views are not finite (N, wh, wh, 3) images")
        geo = scenes.view_geometry(assets, rgb["scene"]["body_pose"],
                                   rv0["global_orient"],
                                   rgb["scene"]["betas"], rv0["cam_wp"],
                                   TREE_WH)
        k3_new.append(dict(k3_case(
            {"verts2d": geo["verts2d"], "verts_z": geo["verts_z"],
             "faces": assets.faces}, TREE_PLAYERS, TREE_WH, 1.0,
            K3_SCENE_PLAIN_B), path="create_proxy"))
        k3_paths["create_proxy_scene"] = cp_k3
        scenes.write_scene_tree(cp, "game0", "scene0", rgb, write_images=True)
        ex = ProxyExtractor(pn_nets[512], wh=TREE_WH, flip_tta=True,
                            device=dev)
        torch.cuda.synchronize()
        t_cp = time.time()
        out = create_proxy_stage(ex, os.path.join(cp, "images"),
                                 os.path.join(cp, "proxynet"),
                                 vis_root=os.path.join(cp, "vis"),
                                 batch_size=CP_BATCH)
        torch.cuda.synchronize()
        cp_s = time.time() - t_cp
        n_cp = TREE_PLAYERS * TREE_VIEWS
        check(out["written"] >= 1, "create_proxy wrote no view: %s" % out)
        ious = []
        for p, _, fs in os.walk(os.path.join(cp, "proxynet")):
            for f in sorted(fs):
                if not f.endswith("_sil.npy"):
                    continue
                got = np.load(os.path.join(p, f)) > 0
                clean = np.load(os.path.join(p.replace(
                    os.path.join(cp, "proxynet"),
                    os.path.join(cp, "proxies")), f)) > 0
                ious.append(float((got & clean).sum()
                                  / max((got | clean).sum(), 1)))
        # A player that failed in a later view is deleted whole, so its
        # earlier views count as written but hold no file.
        check(1 <= len(ious) <= out["written"], "%d silhouettes on disk for "
              "%d views written" % (len(ious), out["written"]))
        pr_root = os.path.join(cp, "predict")
        n_pred = stages.predict_stage(assets, os.path.join(cp, "proxynet"),
                                      os.path.join(cp, "images"), pr_root,
                                      regressor_fn=regressor_fn, device=dev)
        check(n_pred == len(ious), "predict_stage wrote %d of %d views"
              % (n_pred, len(ious)))
        ref_shapes = {"body_pose": (1, 23, 3, 3), "global_orient": (1, 1, 3, 3),
                      "betas": (1, 10), "translation": (1, 3)}
        n_npz = 0
        for p, _, fs in os.walk(pr_root):
            for f in fs:
                z = io_formats.read_fit_npz(os.path.join(p, f))
                check(all(z[k].shape == s_ and z[k].dtype == np.float32
                          and np.isfinite(z[k]).all()
                          for k, s_ in ref_shapes.items()),
                      "predict wrote %s with shapes %s" % (
                          f, {k: v.shape for k, v in z.items()}))
                n_npz += 1
        check(n_npz == n_pred, "%d predict files for %d views"
              % (n_npz, n_pred))
        emit("create_proxy", t, wh=TREE_WH, players=TREE_PLAYERS,
             views=TREE_VIEWS, weights=PN_WEIGHTS[512], flip_tta=True,
             batch=CP_BATCH, written=out["written"],
             failed_players=out["failed_players"],
             wall_s=round(cp_s, 4),
             ms_per_batch=round(cp_s / -(-n_cp // CP_BATCH) * 1e3, 3),
             mask_iou_mean=float(np.mean(ious)), mask_iou=ious,
             predict_views=n_pred, k3_launches=cp_k3,
             k3_rgb_view=k3_new[-1], nvidia_smi=smi)

        # -- cli: the fits that need a scene's views, as subprocesses -------
        # (predict, single-view and calc-metrics run on the clip's chain
        # in e2e_clip; the single-view results multi-view starts from are
        # made in process here.)
        t = time.time()
        c = o
        sv_one = stages.single_view_optimization(
            assets, c["images"], c["proxies"], c["sgl"],
            regressor_fn=regressor_fn, fit_cfg=FitConfig(iters=CLI_ITERS),
            verbose=False, device=dev)
        runs = {
            "multi-view": cli("multi-view", "--image-root", c["images"],
                              "--proxy-root", c["proxies"],
                              "--single-view-root", c["sgl"],
                              "--result-root", c["mul"]),
            "broad-view": cli("broad-view", "--image-root",
                              c["broad_images"], "--proxy-root",
                              c["broad_proxies"], "--multi-view-root",
                              c["mul"], "--result-root", c["broad"],
                              "--iters", str(CLI_ITERS))}
        broad_metrics = io_formats.calc_metrics(c["broad"])
        n1 = TREE_PLAYERS * TREE_VIEWS
        check(sv_one["count"] == n1
              and runs["multi-view"][0]["count"] == TREE_PLAYERS
              and runs["broad-view"][0]["count"] == TREE_PLAYERS
              and broad_metrics["num_players"] == TREE_PLAYERS,
              "the CLI printed %s, the broad tree's metrics %s"
              % ({k: v[0] for k, v in runs.items()}, broad_metrics))
        emit("cli", t, players=TREE_PLAYERS, views=TREE_VIEWS,
             iters=CLI_ITERS, runs={k: {"json": v[0], "wall_s": v[1]}
                                    for k, v in runs.items()},
             broad_calc_metrics=broad_metrics, nvidia_smi=smi)
        return k12_paths, k3_paths, k12_new, k3_new

    def clip_phases(work: str, rgb_images: str):
        """The one-clip rehearsal (e2e_clip) and the front end's stages in
        process (front_stages) under ``work``; ``rgb_images`` is the RGB
        scene's per-view crop tree that create_proxy wrote. Returns the
        K1/K2 and K3 launches by path and the new K1/K2 and K3 shapes."""
        import cv2
        from soccerplayershapepose_torch.pipeline import (
            classification, video)
        from soccerplayershapepose_torch.pipeline import extract as textract
        from soccerplayershapepose_torch import cli as tcli
        k12_paths, k3_paths, k12_new, k3_new = {}, {}, [], []
        with open(os.path.join(root, E2E_CLIP_RECORD)) as f:
            clip_record = json.load(f)
        rec_cm = clip_record["calc_metrics"]["result"]
        d = {k: os.path.join(work, "clip", k) for k in (
            "Broad", "BroadBox", "BroadPlayer", "BroadProxy", "SglInit",
            "Sgl", "predict_in_process", "det", "crop_player", "box_index",
            "players_index", "sgl_default", "profile_default")}
        clip_path = os.path.join(work, "clip", "clip.mp4")
        os.makedirs(os.path.dirname(clip_path))

        # -- e2e_clip: video -> gate -> boxes, crops -> proxies -> fits ----
        t = time.time()
        h, w = CLIP_HW
        gen = torch.Generator(device=dev).manual_seed(CLIP_SEED)
        frame_draws, crop_draws = [], []

        def make_clip():
            wide, close = [], []
            for _ in range(0, CLIP_WIDE, CLIP_BATCH):
                frame_draws.append(synth.sample_frame_draws(
                    gen, CLIP_BATCH, CLIP_PLAYERS, CLIP_HW))
                b = synth.render_frame_batch(assets, frame_draws[-1], CLIP_HW)
                wide += list(straps.crop_images_u8(b["image"]).cpu().numpy())
            for _ in range(0, CLIP_CLOSE, CLIP_BATCH):
                crop_draws.append(synth.sample_crop_draws(
                    gen, CLIP_BATCH, image_wh=CLIP_CROP_WH))
                b = synth.render_crop_batch(assets, crop_draws[-1],
                                            CLIP_CROP_WH, with_image=True)
                for img in straps.crop_images_u8(b["image"]).cpu().numpy():
                    canvas = np.zeros((h, w, 3), np.uint8)
                    x0 = (w - CLIP_CROP_WH) // 2
                    canvas[:, x0:x0 + CLIP_CROP_WH] = img
                    close.append(canvas)
            # Close-ups scattered through the broadcast, as the rehearsal
            # script interleaves them.
            order = wide[:]
            step = max(len(order) // (len(close) + 1), 1)
            for k, c in enumerate(close):
                order.insert(min((k + 1) * step + k, len(order)), c)
            vw = cv2.VideoWriter(clip_path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 CLIP_FPS, (w, h))
            check(vw.isOpened(), "cv2 cannot write an mp4v clip")
            for f in order:
                vw.write(np.ascontiguousarray(f[..., ::-1]))
            vw.release()
            return len(wide), len(close)

        (n_wide, n_close), synth_s, _, clip_k3 = counted(make_clip)
        n_frames = video.video_frame_count(clip_path)
        check(n_frames == n_wide + n_close and clip_k3 == (
            CLIP_WIDE // CLIP_BATCH + 2 * (CLIP_CLOSE // CLIP_BATCH)),
            "the clip holds %d frames, its synthesis launched K3 %d times"
            % (n_frames, clip_k3))
        k3_paths["e2e_clip_synthesis"] = clip_k3
        runs = {}
        runs["harvest-frames"] = cli(
            "harvest-frames", "--video", clip_path, "--out-root", d["Broad"],
            "--n-samples", str(CLIP_SAMPLES), "--max-accepted",
            str(CLIP_MAX_ACCEPTED), "--height", str(h), "--width", str(w),
            "--classifier-params", os.path.join(root, CLS_WEIGHTS))
        runs["crop-broad-player"] = cli(
            "crop-broad-player", "--frame-root", d["Broad"], "--box-root",
            d["BroadBox"], "--player-root", d["BroadPlayer"])
        runs["create-proxy"] = cli("create-proxy", "--image-root",
                                   d["BroadPlayer"], "--proxy-root",
                                   d["BroadProxy"])
        runs["predict"] = cli("predict", "--image-root", d["BroadPlayer"],
                              "--proxy-root", d["BroadProxy"],
                              "--result-root", d["SglInit"])
        runs["single-view"] = cli("single-view", "--image-root",
                                  d["BroadPlayer"], "--proxy-root",
                                  d["BroadProxy"], "--result-root", d["Sgl"],
                                  "--iters", str(CLIP_ITERS))
        runs["calc-metrics"] = cli("calc-metrics", "--root", d["Sgl"])
        hv, cb, cp_out, pr, sv, cm = (runs[k][0] for k in (
            "harvest-frames", "crop-broad-player", "create-proxy", "predict",
            "single-view", "calc-metrics"))
        harvest = hv["videos"][0]
        game_dir = os.path.join(d["Broad"], harvest["game"])
        check(0 < hv["accepted"] <= CLIP_MAX_ACCEPTED and all(
            os.path.isfile(os.path.join(game_dir, s_, "broad.png"))
            for s_ in harvest["scenes"]),
            "harvest-frames printed %s" % hv)
        n_boxes = sum(len(io_formats.read_boxes(os.path.join(p, f)))
                      for p, _, fs in os.walk(d["BroadBox"]) for f in fs
                      if f == "boxes.xml")
        n_crops = sum(f == "player.png" for _, _, fs in
                      os.walk(d["BroadPlayer"]) for f in fs)
        check(cb["boxes"] == cb["images"]["crops"] == n_boxes == n_crops > 0,
              "crop-broad-player printed %s; %d boxes and %d crops on disk"
              % (cb, n_boxes, n_crops))
        proxied = sorted(os.path.relpath(p, d["BroadProxy"])
                         for p, _, fs in os.walk(d["BroadProxy"]) for f in fs
                         if f.endswith("_sil.npy"))
        check(len(proxied) >= CLIP_PROXY_FRAC * n_crops,
              "create-proxy wrote %d proxies for %d crops (%s)"
              % (len(proxied), n_crops, cp_out))
        ref_shapes = {"body_pose": (1, 23, 3, 3),
                      "global_orient": (1, 1, 3, 3), "betas": (1, 10),
                      "translation": (1, 3)}
        n_npz = 0
        for p, _, fs in os.walk(d["SglInit"]):
            for f in fs:
                z = io_formats.read_fit_npz(os.path.join(p, f))
                check(all(z[k].shape == s_ and z[k].dtype == np.float32
                          and np.isfinite(z[k]).all()
                          for k, s_ in ref_shapes.items()),
                      "predict wrote %s with shapes %s" % (
                          f, {k: v.shape for k, v in z.items()}))
                n_npz += 1
        check(pr == {"views": len(proxied)} and n_npz == len(proxied),
              "predict printed %s and wrote %d files for %d proxied views"
              % (pr, n_npz, len(proxied)))
        check(sv["count"] == len(proxied) and cm["num_players"] == sv["count"],
              "single-view fitted %s views, calc-metrics counted %s"
              % (sv["count"], cm["num_players"]))
        # The CLI's predict files against the in-process stage on the card.
        stages.predict_stage(assets, d["BroadProxy"], d["BroadPlayer"],
                             d["predict_in_process"],
                             regressor_fn=regressor_fn, device=dev)
        cli_err = 0.0
        for p, _, fs in os.walk(d["SglInit"]):
            for f in fs:
                a = io_formats.read_fit_npz(os.path.join(p, f))
                b = io_formats.read_fit_npz(os.path.join(
                    p.replace(d["SglInit"], d["predict_in_process"]), f))
                for k in a:
                    scale = np.abs(b[k]).max() if k == "translation" else 1.0
                    cli_err = max(cli_err, float(np.abs(a[k] - b[k]).max()
                                                 / scale))
        check(cli_err <= CLI_TOL, "the CLI's predict files differ from the "
              "in-process stage by %.3g" % cli_err)
        held = {}
        for k in ("mean_silh_iou", "mean_joint_err"):
            held[k] = [cm[k], rec_cm[k]]
        within = all(np.isfinite(g) and abs(g - r) <= RECORD_REL * abs(r)
                     for g, r in held.values())
        emit("e2e_clip", t, seed=CLIP_SEED, hw=list(CLIP_HW),
             wide_frames=n_wide, closeup_frames=n_close,
             players_per_frame=CLIP_PLAYERS, clip_frames=n_frames,
             synthesis_wall_s=round(synth_s, 4), k3_launches=clip_k3,
             runs={k: {"json": v[0], "wall_s": v[1]}
                   for k, v in runs.items()},
             record=E2E_CLIP_RECORD,
             record_walls_s={k: clip_record[k]["wall_s"] for k in (
                 "harvest", "crop_broad", "create_proxy", "predict",
                 "single_view", "calc_metrics")},
             proxied_views=len(proxied), crops=n_crops,
             held_to_record=held, record_rel_tol=RECORD_REL,
             within_record=within,
             predict_vs_in_process_max=cli_err, tol=CLI_TOL, nvidia_smi=smi)
        check(within, "the clip's calc-metrics %s are not within %d%% of the "
              "record" % (held, RECORD_REL * 100))

        # -- classifier_parity: the gate on the card vs the CPU ------------
        t = time.time()
        # The frames harvest-frames sampled (its seed 0), in its order.
        pairs = list(video.sample_video_frames(
            clip_path, CLIP_SAMPLES, seed=0,
            size_hw=CLIP_HW))[:harvest["sampled"]]
        positions = [p_ for p_, _ in pairs]
        sampled = [f for _, f in pairs]
        gate = classification.load_classifier(
            os.path.join(root, CLS_WEIGHTS), dev)
        gate_cpu = classification.load_classifier(
            os.path.join(root, CLS_WEIGHTS), "cpu")
        feats = np.stack([gate.feature_fn(f) for f in sampled])
        feats_cpu = np.stack([gate_cpu.feature_fn(f) for f in sampled])
        logits = np.stack([gate.logits(f) for f in sampled])
        logits_cpu = np.stack([gate_cpu.logits(f) for f in sampled])
        feat_rel = float(np.abs(feats - feats_cpu).max()
                         / np.abs(feats_cpu).max())
        logit_gap = float(np.abs(logits - logits_cpu).max())
        logit_rel = logit_gap / float(np.abs(logits_cpu).max())
        check(feat_rel <= CLS_TOL and logit_rel <= CLS_TOL,
              "the classifier on the card differs from the CPU: features "
              "%.3g, logits %.3g relative" % (feat_rel, logit_rel))
        accept = logits.argmax(1) == 1
        accept_cpu = logits_cpu.argmax(1) == 1
        margin = np.abs(logits_cpu[:, 1] - logits_cpu[:, 0])
        flips = accept != accept_cpu
        check(bool((margin[flips] <= 2 * logit_gap).all()),
              "a decision differs at a margin above twice the logit gap")
        # The in-process gate reproduces the CLI's accepted scenes (one
        # name per accepted draw; the draws repeat positions): each draw
        # harvest-frames classified is accepted there exactly when the gate
        # here accepts it, but for a near-tie (a margin within twice the
        # card-vs-CPU logit gap), which may go either way.
        near_tie = margin <= 2 * logit_gap
        names = ["%08d" % p_ for p_ in positions]
        cli_kept = Counter(harvest["scenes"])
        gate_kept = Counter(n_ for n_, a in zip(names, accept) if a)
        sure = Counter(n_ for n_, a, nt in zip(names, accept, near_tie)
                       if a and not nt)
        maybe = Counter(n_ for n_, a, nt in zip(names, accept, near_tie)
                        if a or nt)
        check(not (sure - cli_kept) and not (cli_kept - maybe),
              "the gate accepts %s, harvest-frames %s"
              % (sorted(gate_kept.elements()), harvest["scenes"]))
        for f in sampled[:2]:
            gate.process(f)
        torch.cuda.synchronize()
        t_g = time.time()
        for f in sampled:
            gate.process(f)
        gate_ms = (time.time() - t_g) / len(sampled) * 1e3
        t_p = time.time()
        for f in sampled:
            classification.preprocess_frame(f)
        pre_ms = (time.time() - t_p) / len(sampled) * 1e3
        emit("classifier_parity", t, weights=CLS_WEIGHTS,
             frames=len(sampled), accepted_card=int(accept.sum()),
             accepted_cpu=int(accept_cpu.sum()), feature_max_rel=feat_rel,
             logit_max_rel=logit_rel, logit_gap=logit_gap, tol=CLS_TOL,
             near_tie_flips=int(flips.sum()),
             min_margin=float(margin.min()),
             gate_ms_per_frame=round(gate_ms, 3),
             preprocess_ms_per_frame=round(pre_ms, 3),
             near_tie_draws=int(near_tie.sum()),
             matches_cli=gate_kept == cli_kept, nvidia_smi=smi)

        # -- front_stages: the detect and crop stages in process -----------
        t = time.time()
        det_thresh = tcli._resolve_score_thresh(
            argparse.Namespace(score_thresh=None),
            os.path.join(root, DET_WEIGHTS))
        det_model = load_detector_weights(os.path.join(root, DET_WEIGHTS),
                                          dev)
        split = {}
        real = {"read": textract.read_image, "encode": io_formats.write_png}

        def run_stage(fn, runner):
            """``fn(runner)`` timed, its wall split into the detector's
            forward (numpy boxes out, so the card has finished), the PNG
            reads and encodes, and the host crop and resize (the rest)."""
            split.clear()
            textract.read_image = timed(split, "png_read", real["read"])
            io_formats.write_png = timed(split, "png_encode", real["encode"])
            try:
                torch.cuda.synchronize()
                t0 = time.time()
                out = fn(runner)
                wall = time.time() - t0
            finally:
                textract.read_image = real["read"]
                io_formats.write_png = real["encode"]
            rest = wall - sum(split.values())
            return out, {"wall_s": round(wall, 4),
                         **{k + "_s": round(v, 4) for k, v in split.items()},
                         "host_crop_resize_s": round(rest, 4)}

        class Runner(textract.PlayerDetectorRunner):
            def __call__(self, frames_u8):
                return timed(split, "detector", super().__call__)(frames_u8)

        det, det_t = run_stage(lambda r: textract.detect_players_stage(
            r, d["Broad"], d["det"]), Runner(
                det_model, CLIP_HW, score_thresh=det_thresh, device=dev))
        det_files = [os.path.relpath(os.path.join(p, f), d["det"])
                     for p, _, fs in os.walk(d["det"]) for f in fs]
        n_scenes = len(os.listdir(game_dir))
        det_boxes = {}
        for f in det_files:
            if f.endswith("boxes.xml"):
                det_boxes[os.path.dirname(f)] = io_formats.read_boxes(
                    os.path.join(d["det"], f))
        box_gap = max(float(np.abs(b_ - io_formats.read_boxes(os.path.join(
            d["BroadBox"], s_, "boxes.xml"))).max(initial=0.0))
            for s_, b_ in det_boxes.items())
        check(det["scenes"] == n_scenes == len(det_boxes)
              and det["boxes"] == cb["boxes"] and box_gap <= 1e-3
              and sum(f.endswith("player.png") for f in det_files)
              == det["boxes"],
              "detect_players_stage gave %s, %d scenes, boxes %.3g px from "
              "the CLI's" % (det, n_scenes, box_gap))
        views = sorted(os.path.relpath(os.path.join(p, f), rgb_images)
                       for p, _, fs in os.walk(rgb_images) for f in fs
                       if f.endswith(".png"))
        cp_res, cp_t = run_stage(lambda r: textract.crop_player_stage(
            r, rgb_images, d["crop_player"], save_mid=True), Runner(
                det_model, CROP_PLAYER_HW, score_thresh=det_thresh,
                device=dev))
        cp_files = sorted(os.path.relpath(os.path.join(p, f),
                                          d["crop_player"])
                          for p, _, fs in os.walk(d["crop_player"])
                          for f in fs)
        check(cp_res["written"] + len(cp_res["missed"]) == len(views)
              and cp_res["written"] > 0 and cp_res["skipped"] == 0
              and len(cp_files) == 2 * cp_res["written"],
              "crop_player_stage gave %s for %d views, %d files"
              % ({k: v for k, v in cp_res.items() if k != "missed"},
                 len(views), len(cp_files)))
        with open(os.path.join(d["crop_player"], cp_files[0]), "rb") as f:
            check(decode_png(f.read()).shape == (512, 512, 3),
                  "crop_player_stage's crops are not 512^2 RGB")
        # The box tree again with an index.xml for its first scene: its
        # players are written under the given ids.
        shutil.copytree(d["BroadBox"], d["box_index"])
        first = next(s_ for s_ in sorted(det_boxes) if len(det_boxes[s_]))
        n_first = len(det_boxes[first])
        ids = list(range(100, 100 + n_first))
        io_formats.write_index(os.path.join(d["box_index"], first,
                                            "index.xml"), ids)
        ix, ix_t = run_stage(lambda r: textract.crop_broad_player_images_stage(
            d["box_index"], d["Broad"], d["players_index"]), None)
        check(ix == {"scenes": n_scenes, "crops": cb["boxes"]}
              and sorted(os.listdir(os.path.join(d["players_index"], first)))
              == sorted(str(i) for i in ids),
              "crop_broad_player_images_stage gave %s" % ix)
        emit("front_stages", t, score_thresh=det_thresh,
             detect_players=dict(det, hw=list(CLIP_HW), **det_t),
             crop_player=dict(written=cp_res["written"],
                              missed=len(cp_res["missed"]),
                              views=len(views), hw=list(CROP_PLAYER_HW),
                              **cp_t),
             crop_broad_player_images=dict(ix, indexed_scene=first, **ix_t),
             nvidia_smi=smi)

        # -- clip_single_view: the stage at its defaults on the clip --------
        t = time.time()
        n_views = len(proxied)
        sv_b = -(-n_views // STAGE_BATCH)
        sv_d, sv_s, sv_k12, _ = counted(
            lambda: stages.single_view_optimization(
                assets, d["BroadPlayer"], d["BroadProxy"], d["sgl_default"],
                regressor_fn=regressor_fn, batch_size=STAGE_BATCH,
                verbose=False, device=dev))
        sv_it = sv_b * cfg.SINGLE_VIEW_ITERS
        check(sv_k12 == {"band_raster_fwd": sv_it, "band_raster_bwd": sv_it}
              and sv_d["count"] == n_views,
              "the clip's default stage launched K1/K2 %s times for %s"
              % (sv_k12, sv_d))
        check(sv_d["opt_iou"] > sv_d["init_iou"]
              and sv_d["opt_err"] < sv_d["init_err"],
              "the clip's default fit does not improve IoU and joint error: "
              "%s" % sv_d)
        k12_paths["clip_single_view"] = sv_k12
        # K1/K2 at the stage's shape: its first batch, the regressor's
        # init of the clip's first 32 views (the last repeated up to 32,
        # as the stage pads), rendered at 512^2.
        nodes = stages._gather_views(d["BroadPlayer"], d["BroadProxy"],
                                     True)[:STAGE_BATCH]
        nodes += nodes[-1:] * (STAGE_BATCH - len(nodes))   # as _pad_batch
        sils, j2ds = [], []
        for node, view in nodes:
            s_i, j_i = stages.load_proxy_batch(
                os.path.join(d["BroadProxy"], node.game, node.scene,
                             node.player), [view])
            sils.append(s_i[0])
            j2ds.append(j_i[0])
        with torch.no_grad():
            init = regressor_fn(assets, torch.from_numpy(np.stack(sils)).to(
                dev), torch.from_numpy(np.stack(j2ds)).to(dev))
        rot = init.pose_rotmats
        k12_new.append(dict(k12_case(
            rows_verts2d(rot[:, 1:], rot[:, :1], init.betas, init.cam_wp,
                         TREE_WH), TREE_WH, K12_DEFAULT_PLAIN_B),
            path="clip_single_view"))
        emit("clip_single_view", t, batch=STAGE_BATCH, render_wh=TREE_WH,
             iters=cfg.SINGLE_VIEW_ITERS, views=n_views, metrics=sv_d,
             wall_s=round(sv_s, 4), iterations=sv_it,
             ms_per_iter=round(sv_s / sv_it * 1e3, 3),
             views_per_s=round(n_views / sv_s, 3), k1_k2_launches=sv_k12,
             kernels_at_shape={k: v for k, v in k12_new[-1].items()
                               if k != "max_abs"},
             profile_note="%d iterations a batch" % PROFILE_ITERS,
             profile=device_profile(lambda: stages.single_view_optimization(
                 assets, d["BroadPlayer"], d["BroadProxy"],
                 d["profile_default"], regressor_fn=regressor_fn,
                 batch_size=STAGE_BATCH,
                 fit_cfg=dataclasses.replace(FitConfig(),
                                             iters=PROFILE_ITERS),
                 verbose=False, device=dev)), nvidia_smi=smi)

        # -- k3_clip_parity: K3 at the clip's frame and close-up passes ----
        t = time.time()
        fscn = synth.frame_scene(assets, frame_draws[0], CLIP_HW)
        cscn = synth.crop_scene(assets, synth.draws_to(crop_draws[0], dev),
                                CLIP_CROP_WH)
        k3_clip = [dict(k3_case(fscn, CLIP_BATCH, fscn["wh"], 1.0,
                                K3_CLIP_PLAIN_B), path="e2e_clip_frames")]
        k3_clip += [dict(k3_case(cscn, CLIP_BATCH, wh_, scale),
                         path="e2e_clip_closeups")
                    for wh_, scale in ((CLIP_CROP_WH, 1.0),
                                       (CLIP_CROP_WH // 4, 0.25))]
        emit("k3_clip_parity", t, flops_per_pair=K3_FLOPS_PER_PAIR,
             shapes=k3_clip, nvidia_smi=smi)
        k3_new += k3_clip
        return k12_paths, k3_paths, k12_new, k3_new

    def train_phases(work: str):
        """The training phases on the mint tree under ``work`` (and its
        one-scene copy, whose broadcast fits the cli phase wrote): returns
        the K1/K2 launches by path and the trainer's K1/K2 shape."""
        tree = os.path.join(work, "mint")
        d = {k: os.path.join(tree, k) for k in (
            "images", "proxies", "broad_images", "broad_proxies", "broad",
            "scenes")}
        one = os.path.join(work, "one_scene")
        o = {k: os.path.join(one, k) for k in (
            "broad_images", "broad_proxies", "broad")}
        broad = (d["broad_images"], d["broad_proxies"], d["broad"])
        weights = os.path.join(root, WEIGHTS)

        def committed_state(device=dev, lr=DISTILL_LR):
            return distill.make_train_state(
                load_regressor_weights(weights, device), learning_rate=lr)

        def timed_steps(module, name, times):
            """Run ``fn`` with ``module.<name>`` (a step factory) making
            steps that append their synchronised wall s to ``times``."""
            real = getattr(module, name)

            def make(*a, **kw):
                step = real(*a, **kw)

                def step_timed(*sa, **skw):
                    t0 = time.time()
                    out = step(*sa, **skw)
                    torch.cuda.synchronize()
                    times.append(time.time() - t0)
                    return out
                return step_timed

            def run(fn):
                setattr(module, name, make)
                try:
                    return fn()
                finally:
                    setattr(module, name, real)
            return run

        def per_scene(fn, divisor):
            """``fn()`` (an evaluation over the tree's scenes) with each
            scene's metric means kept from the sums it computes anyway:
            (its result, [per-scene means])."""
            real, scenes = training._metric_sums, []

            def keep(aux, mask):
                sums = real(aux, mask)
                scenes.append(training._means(
                    sums, int(np.sum(mask)), divisor))
                return sums
            training._metric_sums = keep
            try:
                return fn(), scenes
            finally:
                training._metric_sums = real

        def rel_gaps(got, want):
            return {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
                    for k in want if k not in ("num_players",
                                               "joints2D_l2es")}

        # -- distill_train: the distillation trainer on the broadcast tree --
        t = time.time()
        ck = os.path.join(work, "distill_ckpt")
        # The first step on one scene, card against CPU, from the same
        # warm start.
        b0 = training.gather_scene_batches(*broad, DISTILL_PLAYERS)[0]
        first = {}
        for where in ("cpu", dev):
            st = committed_state(where)
            _, m, _ = distill.make_train_step()(
                st, assets, training._device_batch(b0, torch.device(where)))
            first[str(where)] = float(m["loss"])
        loss_gap = abs(first[str(dev)] - first["cpu"]) / abs(first["cpu"])
        check(loss_gap <= DISTILL_LOSS_REL,
              "the first distillation step's loss on the card %.6g vs the "
              "CPU %.6g" % (first[str(dev)], first["cpu"]))
        # The committed regressor's evaluation, with each scene's metrics
        # kept: relate_eval's arm without the relation module too.
        before, before_scenes = per_scene(
            lambda: training.evaluate_model(assets, *broad,
                                            committed_state()),
            training._divisor)
        step_s = []
        kw = dict(max_players=DISTILL_PLAYERS, learning_rate=DISTILL_LR,
                  seed=DISTILL_SEED, init_weights=weights,
                  log_path=os.path.join(work, "distill_tracker.pkl"),
                  device=dev)
        run3, run3_s, run3_k12, _ = counted(lambda: timed_steps(
            training, "make_train_step", step_s)(
                lambda: training.train_regressor(
                    assets, *broad, ck, epochs=DISTILL_EPOCHS, **kw)))
        run4, run4_s, _, _ = counted(lambda: training.train_regressor(
            assets, *broad, ck, epochs=DISTILL_EPOCHS + 1, resume=True,
            **kw))
        n_scenes = len(training.gather_scene_batches(*broad,
                                                     DISTILL_PLAYERS))
        hist = run4["history"]
        check(run3_k12 == {"band_raster_fwd": 0, "band_raster_bwd": 0},
              "the distillation trainer launched K1/K2: %s" % run3_k12)
        check(run4["state"].step == (DISTILL_EPOCHS + 1) * n_scenes
              and all(len(v) == DISTILL_EPOCHS + 1 for v in hist.values()),
              "the resumed run holds %d steps and %s epochs"
              % (run4["state"].step, {len(v) for v in hist.values()}))
        check(hist["train_losses"][:DISTILL_EPOCHS]
              == run3["history"]["train_losses"],
              "the resumed history does not continue the first run's")
        check(all(np.isfinite(v).all() for v in hist.values()),
              "a tracked metric is not finite: %s" % hist)
        after = training.evaluate_model(assets, *broad, run4["state"],
                                        DISTILL_PLAYERS)
        check(all(np.isfinite(v) for v in after.values()),
              "evaluate_model after training: %s" % after)
        # The saved fp16 weights reload as the trained weights rounded.
        npz = os.path.join(work, "regressor_18ch_distilled.npz")
        straps.save_regressor_weights(npz, run4["state"].regressor,
                                      dtype=np.float16)
        back = load_regressor_weights(npz, dev)
        trained = run4["state"].regressor.eval()
        for k, v in trained.state_dict().items():
            if v.is_floating_point():
                check(torch.equal(back.state_dict()[k],
                                  v.half().float()),
                      "%s did not reload as its fp16 rounding" % k)
        db0 = training._device_batch(b0, dev)
        init0 = distill.default_initial_params(assets.mean_pose_rot6d,
                                               assets.mean_shape)
        with torch.no_grad():
            p_back, p_tr = back(db0["proxy"], init0), trained(db0["proxy"],
                                                              init0)
        fp16_gap = max(float((a - b_).abs().max())
                       for a, b_ in zip(p_back, p_tr))
        prof_state = committed_state()
        prof_step = distill.make_train_step()
        prof_batch = training._device_batch(b0, dev)
        prof_step(prof_state, assets, prof_batch)
        profile = device_profile(lambda: [prof_step(prof_state, assets,
                                                    prof_batch)
                                          for _ in range(
                                              DISTILL_PROFILE_STEPS)])
        steady = step_s[1:] if len(step_s) > 1 else step_s
        emit("distill_train", t, scenes=n_scenes, rows=DISTILL_PLAYERS,
             lr=DISTILL_LR, seed=DISTILL_SEED,
             epochs=DISTILL_EPOCHS + 1, resumed_at=DISTILL_EPOCHS + 1,
             reduced_from="8 games x 20 epochs (weights/distill_r05/"
             "train_history.json); 1 game x 4 epochs here",
             first_step_loss={"card": first[str(dev)], "cpu": first["cpu"],
                              "rel_gap": loss_gap, "tol": DISTILL_LOSS_REL},
             train_s={"3_epochs": round(run3_s, 4),
                      "resumed_4th": round(run4_s, 4)},
             steps=len(step_s), step_timing="the train step alone, "
             "synchronised (not the batch's proxy or the metric sums)",
             ms_per_step=round(float(np.mean(steady)) * 1e3, 3),
             steps_per_s=round(1.0 / float(np.mean(steady)), 3),
             best_epoch=run4["best_epoch"],
             best_val={k: float(v) for k, v in run4["best_val"].items()},
             val_pves_pa=hist["val_pves_pa"],
             val_mpjpes_pa=hist["val_mpjpes_pa"],
             train_losses=hist["train_losses"],
             evaluate_model_before=before, evaluate_model_after=after,
             fp16_reload_max_abs_vs_fp32=fp16_gap,
             k1_k2_launches=run3_k12,
             profile_note="%d train steps of one scene (8 rows), the "
             "committed warm start" % DISTILL_PROFILE_STEPS,
             profile=profile, nvidia_smi=smi)

        # -- selfsup_train: K1/K2 at sigma 1e-4 in a training step ----------
        t = time.time()
        views = stages._gather_views(d["images"], d["proxies"],
                                     True)[:SELFSUP_ROWS]
        sils, j2ds = [], []
        for node, view in views:
            s_i, j_i = stages.load_proxy_batch(
                os.path.join(d["proxies"], node.game, node.scene,
                             node.player), [view])
            sils.append(s_i[0])
            j2ds.append(j_i[0])
        sil_t = torch.from_numpy(np.stack(sils)).to(dev)
        j2d_t = torch.from_numpy(np.stack(j2ds)).to(dev)
        ss_batch = {"proxy": create_proxy_representation(sil_t, j2d_t),
                    "silhouette": sil_t, "joints2d": j2d_t[..., :2]}
        ss_step = selfsup.make_selfsup_step("both", render_wh=SELFSUP_WH,
                                            sigma=SELFSUP_SIGMA)
        # One step on 2 rows through K1/K2 and through the plain route.
        two = {k: v[:SELFSUP_PLAIN_B] for k, v in ss_batch.items()}

        def plain_render(vertices, translation, faces_, img_wh, focal,
                         sigma, render_wh):
            v2d = perspective_project(vertices, None, translation,
                                      focal_length=focal, img_wh=img_wh)
            return softras.soft_silhouette(v2d * (render_wh / img_wh),
                                           faces_, render_wh, sigma=sigma)

        routes = {}
        for route in ("kernels", "plain"):
            st = selfsup.make_selfsup_state(
                load_regressor_weights(weights, dev), "both", SELFSUP_LR)
            real_render = selfsup.render_silhouette
            if route == "plain":
                selfsup.render_silhouette = plain_render
            try:
                (_, m, _), r_s, r_k12, _ = counted(lambda: ss_step(
                    st, assets, two))
            finally:
                selfsup.render_silhouette = real_render
            routes[route] = (float(m["loss"]),
                             st.regressor.encoder.conv.weight.grad.clone(),
                             r_k12, r_s)
        check(routes["kernels"][2] == {"band_raster_fwd": 1,
                                       "band_raster_bwd": 1}
              and routes["plain"][2] == {"band_raster_fwd": 0,
                                         "band_raster_bwd": 0},
              "the selfsup step's launches: %s / %s"
              % (routes["kernels"][2], routes["plain"][2]))
        ss_loss_gap = abs(routes["kernels"][0] - routes["plain"][0]) \
            / abs(routes["plain"][0])
        ss_grad_gap = rel_l2(routes["kernels"][1], routes["plain"][1])
        check(ss_loss_gap <= SELFSUP_LOSS_REL
              and ss_grad_gap <= SELFSUP_GRAD_REL,
              "the selfsup step through K1/K2 disagrees with the plain "
              "route: loss %.3g, stem gradient %.3g" % (ss_loss_gap,
                                                        ss_grad_gap))
        # The 10 steps of the path.
        st = selfsup.make_selfsup_state(load_regressor_weights(weights, dev),
                                        "both", SELFSUP_LR)
        ss_step(st, assets, ss_batch)      # warm-up, not counted
        st = selfsup.make_selfsup_state(load_regressor_weights(weights, dev),
                                        "both", SELFSUP_LR)
        curve = []

        def ten_steps():
            for _ in range(SELFSUP_STEPS):
                _, m, _ = ss_step(st, assets, ss_batch)
                curve.append((float(m["joints2D_l2e"]),
                              float(m["silh_iou"]), float(m["loss"])))

        _, ss_s, ss_k12, _ = counted(ten_steps)
        check(ss_k12 == {"band_raster_fwd": SELFSUP_STEPS,
                         "band_raster_bwd": SELFSUP_STEPS},
              "the self-supervised steps launched K1/K2 %s times" % ss_k12)
        arr = np.array(curve)
        check(np.isfinite(arr).all(), "selfsup metrics not finite: %s"
              % curve)
        check(arr[-3:, 2].mean() < arr[0, 2] and arr[-3:, 1].mean()
              > arr[0, 1],
              "the self-supervised steps do not lower the loss and raise the "
              "IoU: %s" % curve)
        # Item 'pose' (joints 2D alone, no render) on the same batch.
        st = selfsup.make_selfsup_state(load_regressor_weights(weights, dev),
                                        "pose", SELFSUP_LR)
        pose_step = selfsup.make_selfsup_step("pose")
        pose_curve = [float(pose_step(st, assets, ss_batch)[1]
                            ["joints2D_l2e"]) for _ in range(SELFSUP_STEPS)]
        check(np.isfinite(pose_curve).all()
              and np.mean(pose_curve[-3:]) < pose_curve[0],
              "the 'pose' steps do not lower the joints-2D error: %s"
              % pose_curve)
        # K1/K2 at the trainer's shape: the 8 rows' bodies as the
        # committed regressor predicts them, at 512^2 and sigma 1e-4.
        with torch.no_grad():
            pred = predict_smpl(load_regressor_weights(weights, dev), assets,
                                sil_t, j2d_t, device=dev)
            v2d = perspective_project(pred.vertices, None, pred.translation,
                                      focal_length=cfg.FOCAL_LENGTH,
                                      img_wh=PROXY_WH).contiguous()
        case = dict(k12_case(v2d, SELFSUP_WH, SELFSUP_PLAIN_B,
                             sigma=SELFSUP_SIGMA), path="selfsup_train")
        emit("selfsup_train", t, rows=SELFSUP_ROWS, wh=SELFSUP_WH,
             sigma=SELFSUP_SIGMA, item="both", lr=SELFSUP_LR,
             steps=SELFSUP_STEPS, wall_s=round(ss_s, 4),
             ms_per_step=round(ss_s / SELFSUP_STEPS * 1e3, 3),
             joints2d_l2e=arr[:, 0].tolist(), silh_iou=arr[:, 1].tolist(),
             loss=arr[:, 2].tolist(), pose_item_joints2d_l2e=pose_curve,
             k1_k2_launches=ss_k12,
             parity={"rows": SELFSUP_PLAIN_B, "loss_rel": ss_loss_gap,
                     "loss_tol": SELFSUP_LOSS_REL,
                     "stem_grad_rel_l2": ss_grad_gap,
                     "grad_tol": SELFSUP_GRAD_REL,
                     "kernels_step_s": round(routes["kernels"][3], 4),
                     "plain_step_s": round(routes["plain"][3], 4)},
             k1_ms=case["ms"]["band_raster_fwd"],
             k2_ms=case["ms"]["band_raster_bwd"],
             bound_ms=case["bound_ms"],
             plain_ms_on_plain_b=case["plain_ms"],
             support_radius_px=case["support_radius_px"],
             support_pairs=case["support_pairs"],
             pairs_evaluated=case["pairs_evaluated"],
             k1_max_abs=case["k1_max_abs"], k2_rel_l2=case["k2_rel_l2"],
             nvidia_smi=smi)

        # -- relate_eval: the relation module on the tree -------------------
        t = time.time()
        base_state = committed_state()
        rel_models = {v: rel_train.load_relation_weights(os.path.join(
            root, REL_WEIGHTS[v]), dev) for v in (0, 1)}
        base, scenes = before, {"without_relation": before_scenes}
        relate = {}
        for v in (0, 1):
            relate[v], scenes["with_relation_v%d" % v] = per_scene(
                lambda: training.evaluate_model_relate(
                    assets, *broad, base_state, relation=rel_models[v],
                    boxes_root=d["scenes"]), training._divisor_relate)
        relate_cam = training.evaluate_model_relate(
            assets, *broad, base_state, relation=rel_models[1],
            boxes_root=d["scenes"], optimize_cam=True)
        # The records hold 192 players of 8 games, the tree 24 of one
        # game's 4 scenes. Each arm's metrics: the record within
        # RELATE_SE standard errors of the tree's mean, the error taken
        # from the arm's per-scene spread; the module's effect (with /
        # without, per metric), which cancels most of the game's level,
        # within RECORD_REL of the record's.
        keys = [k for k in base if k not in ("num_players", "joints2D_l2es")]
        spread = {}
        for arm, rows in scenes.items():
            check(len(rows) == len(before_scenes) >= 2,
                  "relate %s: %d scenes kept" % (arm, len(rows)))
            spread[arm] = {k: {
                "mean": float(np.mean([r[k] for r in rows])),
                "se": float(np.std([r[k] for r in rows], ddof=1)
                            / np.sqrt(len(rows)))} for k in keys}
        held, effect, in_se = {}, {}, {}
        for v in (0, 1):
            with open(os.path.join(root, RELATE_RECORDS[v])) as f:
                rec = json.load(f)
            for arm, name, got in (
                    ("without_relation", "without_relation", base),
                    ("with_relation", "with_relation_v%d" % v, relate[v])):
                tag = "v%d_%s" % (v, arm)
                held[tag] = rel_gaps(got, rec[arm])
                in_se[tag] = {k: abs(got[k] - rec[arm][k])
                              / max(spread[name][k]["se"], 1e-12)
                              for k in keys}
                far = {k: round(g, 2) for k, g in in_se[tag].items()
                       if g > RELATE_SE}
                check(not far, "relate %s: the record lies more than %g "
                      "standard errors of the tree's mean away: %s"
                      % (tag, RELATE_SE, far))
            ratio = {k: relate[v][k] / base[k] for k in keys}
            rec_ratio = {k: rec["with_relation"][k]
                         / rec["without_relation"][k] for k in keys}
            effect["v%d" % v] = {k: [ratio[k], rec_ratio[k]] for k in keys}
            gaps = rel_gaps(ratio, rec_ratio)
            check(max(gaps.values()) <= RECORD_REL,
                  "relate v%d: the module's effect %s is not within %d%% of "
                  "its record's" % (v, {k: round(g, 3) for k, g in
                                        gaps.items() if g > RECORD_REL},
                                    RECORD_REL * 100))
        check(all(np.isfinite(x) for x in relate_cam.values()),
              "evaluate_model_relate with optimize_cam: %s" % relate_cam)
        # One scene on the card against the CPU.
        one_args = (o["broad_images"], o["broad_proxies"], o["broad"])
        one_gpu = training.evaluate_model_relate(
            assets, *one_args, base_state, relation=rel_models[0],
            boxes_root=d["scenes"])
        cpu_state = distill.make_train_state(load_regressor_weights(
            weights, "cpu"))
        one_cpu = training.evaluate_model_relate(
            assets.to("cpu"), *one_args, cpu_state,
            relation=rel_train.load_relation_weights(
                os.path.join(root, REL_WEIGHTS[0]), "cpu"),
            boxes_root=d["scenes"])
        one_gap = max(rel_gaps(one_gpu, one_cpu).values())
        check(one_gap <= RELATE_TOL, "relate on one scene: card vs CPU %.3g"
              % one_gap)
        emit("relate_eval", t, players=base["num_players"],
             record_players=192, record_rel_tol=RECORD_REL,
             without_relation=base, with_relation_v0=relate[0],
             with_relation_v1=relate[1], v1_optimize_cam=relate_cam,
             effect_with_over_without_vs_record=effect,
             rel_gap_to_records=held, scene_spread=spread,
             record_gap_in_se=in_se, record_se_tol=RELATE_SE,
             one_scene_card_vs_cpu=one_gap,
             one_scene_tol=RELATE_TOL, nvidia_smi=smi)

        # -- relation_train: the relation trainer v0 -------------------------
        t = time.time()
        rt_kw = dict(b=8, n_players=6, lr=1e-3, seed=REL_TRAIN_SEED,
                     schedule_steps=REL_TRAIN_SCHEDULE, log_every=1,
                     verbose=False)
        _, h_cpu = rel_train.train_relation(steps=3, device="cpu", **rt_kw)
        _, h_gpu = rel_train.train_relation(steps=3, device=dev, **rt_kw)
        rt_gap = max(abs(a["loss"] - b_["loss"]) / abs(b_["loss"])
                     for a, b_ in zip(h_gpu, h_cpu))
        check(rt_gap <= REL_TRAIN_LOSS_REL,
              "relation training's first 3 steps: card vs CPU %.3g" % rt_gap)
        rt_times = []
        t_rt = time.time()
        _, hist_rt = timed_steps(rel_train, "make_relation_train_step",
                                 rt_times)(lambda: rel_train.train_relation(
                                     steps=REL_TRAIN_STEPS, device=dev,
                                     **rt_kw))
        rt_wall = time.time() - t_rt
        tail = hist_rt[-100:]
        loss_tail = float(np.mean([h["loss"] for h in tail]))
        in_tail = float(np.mean([h["input_mse"] for h in tail]))
        check(np.isfinite(loss_tail) and loss_tail < in_tail,
              "relation training: the last 100 steps' loss %.4g is not below "
              "their input %.4g" % (loss_tail, in_tail))
        ms_step = float(np.median(rt_times)) * 1e3
        emit("relation_train", t, variant="v0", b=8, players=6, lr=1e-3,
             steps=REL_TRAIN_STEPS, schedule_steps=REL_TRAIN_SCHEDULE,
             first_3_card_vs_cpu=rt_gap, tol=REL_TRAIN_LOSS_REL,
             last_100_loss=loss_tail, last_100_input_mse=in_tail,
             wall_s=round(rt_wall, 3),
             ms_per_step_with_batch_draws=round(
                 rt_wall / REL_TRAIN_STEPS * 1e3, 3),
             step_alone_ms_median=round(ms_step, 3),
             projected_3000_steps_s=round(rt_wall * 3000 / REL_TRAIN_STEPS,
                                          2), nvidia_smi=smi)

        # -- cli_train: the train subcommand, then --resume ----------------
        t = time.time()
        ck_cli = os.path.join(work, "cli_ckpt")
        argv = ("train", "--image-root", o["broad_images"], "--proxy-root",
                o["broad_proxies"], "--target-root", o["broad"],
                "--checkpoint-dir", ck_cli)
        r1 = cli(*argv, "--epochs", "1")
        r2 = cli(*argv, "--epochs", "2", "--resume")
        with open(os.path.join(ck_cli, "latest", "meta.json")) as f:
            meta = json.load(f)
        for r in (r1, r2):
            check(set(r[0]) == {"best_epoch", "best_val"}
                  and all(np.isfinite(v) for v in r[0]["best_val"].values()),
                  "train printed %s" % r[0])
        check(meta["epoch"] == 2, "the resumed CLI run ended at epoch %s"
              % meta["epoch"])
        emit("cli_train", t, runs={"epochs_1": {"json": r1[0],
                                                "wall_s": r1[1]},
                                   "resume_epochs_2": {"json": r2[0],
                                                       "wall_s": r2[1]}},
             meta=meta, nvidia_smi=smi)
        return {"selfsup_train": ss_k12}, {}, [case], []

    def perception_phases(work: str):
        """The perception trainers, the extracted batches and the baseline
        evaluations, on the trees under ``work`` (the mint tree and the RGB
        create-proxy scene): returns the K1/K2 and K3 launches by path and
        the new K1/K2 and K3 shapes."""
        k12_paths, k3_paths, k12_new, k3_new = {}, {}, [], []
        tree = os.path.join(work, "mint")
        rgb_images = os.path.join(work, "rgb", "images")
        rgb_proxies = os.path.join(work, "rgb", "proxynet")
        tmp = os.path.join(work, "perception")
        os.makedirs(tmp)

        def first_step_gap(net_cpu, batch_gpu, step_factory):
            """One step of the same net (copied to the card) on the same
            batch, card against CPU: (loss rel gaps, BN statistics rel gap,
            parameter flips, parameters, first-step wall s on the card)."""
            net_gpu = copy.deepcopy(net_cpu).to(dev)
            states = {}
            losses = {}
            for where, net in (("cpu", net_cpu), ("card", net_gpu)):
                d_ = torch.device("cpu") if where == "cpu" else dev
                st = ptrain.make_perception_state(net, PT_LR)
                b_ = {k: v.to(d_) for k, v in batch_gpu.items()}
                t0 = time.time()
                _, losses[where] = step_factory()(st, b_)
                if where == "card":
                    torch.cuda.synchronize()
                states[where] = (st, time.time() - t0)
            loss_rel = {k: abs(float(losses["card"][k]) - float(v))
                        / max(abs(float(v)), 1e-12)
                        for k, v in losses["cpu"].items()}
            sd_c = states["cpu"][0].model.state_dict()
            sd_g = states["card"][0].model.state_dict()
            stats_rel, flips, total = 0.0, 0, 0
            for k, v in sd_c.items():
                g = sd_g[k].cpu()
                if "running_" in k:
                    stats_rel = max(stats_rel, float((g - v).abs().max())
                                    / max(float(v.abs().max()), 1e-12))
                elif v.is_floating_point():
                    gap = (g - v).abs()
                    check(bool((gap <= 2 * PT_LR + 1e-6).all()),
                          "%s moved apart by %.3g in one step"
                          % (k, float(gap.max())))
                    flips += int((gap > 1e-6).sum())
                    total += gap.numel()
            check(max(loss_rel.values()) <= PT_LOSS_REL
                  and stats_rel <= PT_STATS_REL
                  and flips <= PT_FLIP_SHARE * total,
                  "the first step on the card vs the CPU: losses %s, BN "
                  "statistics %.3g, %d of %d parameters apart"
                  % (loss_rel, stats_rel, flips, total))
            return {"loss_rel": loss_rel, "bn_stats_rel": stats_rel,
                    "adam_sign_flips": flips, "params": total,
                    "card_first_step_s": round(states["card"][1], 4),
                    "cpu_step_s": round(states["cpu"][1], 4)}

        def curve(history):
            return [float(h["total"]) for h in history]

        def falls(totals, what):
            check(np.isfinite(totals).all()
                  and np.mean(totals[-3:]) < np.mean(totals[:3]),
                  "%s: the loss does not fall: %s" % (what, totals))

        # -- proxynet_train: ProxyNet on the crop factory, K3 in each step --
        t = time.time()
        gen = torch.Generator().manual_seed(PT_SEED)
        pdraws = synth.sample_crop_draws(gen, PT_BATCH, image_wh=PT_WH)
        pbatch = synth.render_crop_batch(assets, pdraws, PT_WH,
                                         with_image=True)
        parity = first_step_gap(
            ptrain.new_proxynet(gen=torch.Generator().manual_seed(PT_SEED),
                                device="cpu"),
            pbatch, ptrain.make_proxynet_train_step)
        kw = dict(batch=PT_BATCH, wh=PT_WH, log_every=0, device=dev)
        ptrain.train_proxynet_synth(assets, steps=1, seed=PT_SEED, **kw)
        pt_times = {}
        cold, cold_s, _, cold_k3 = counted(lambda: ptrain.train_proxynet_synth(
            assets, steps=PT_STEPS, learning_rate=PT_LR, seed=PT_SEED,
            stage_times=pt_times, **kw))
        check(cold_k3 == 2 * PT_STEPS, "ProxyNet training launched K3 %d "
              "times in %d steps" % (cold_k3, PT_STEPS))
        cold_curve = curve(cold.history)
        falls(cold_curve, "ProxyNet from flax's initialisers")
        # Warm: the committed weights, a few steps at a small lr, saved
        # f16-packed, reloaded and evaluated as their record was.
        warm, warm_s, _, _ = counted(lambda: ptrain.train_proxynet_synth(
            assets, steps=WARM_STEPS, learning_rate=WARM_LR,
            seed=PT_SEED + 1, init_weights=os.path.join(root,
                                                        PN_WEIGHTS[256]),
            **kw))
        pn_path = os.path.join(tmp, "proxynet_warm_f16.npz")
        ptrain.save_perception_weights(pn_path, warm.model, dtype=np.float16,
                                       compress=True)
        pn_back = load_proxynet_weights(pn_path, dev)
        res_pw = quality.evaluate_proxynet(
            ProxyExtractor(pn_back, wh=PT_WH, device=dev), assets,
            n_batches=PN_BATCHES, batch=PN_BATCH, wh=PT_WH)
        with open(os.path.join(root, PN_RECORDS[256])) as f:
            pn_record = json.load(f)
        for k in PN_METRICS:
            check(abs(res_pw[k] - pn_record[k]) <= RECORD_REL * pn_record[k],
                  "warm-started ProxyNet %s %.4f is not within %d%% of the "
                  "record %.4f" % (k, res_pw[k], RECORD_REL * 100,
                                   pn_record[k]))
        pscn = synth.crop_scene(assets, synth.draws_to(pdraws, dev), PT_WH)
        k3_pt = [dict(k3_case(pscn, PT_BATCH, wh_, scale, K3_TRAIN_PLAIN_B),
                      path="proxynet_train")
                 for wh_, scale in ((PT_WH, 1.0), (PT_WH // 4, 0.25))]
        k3_new += k3_pt
        k3_paths["proxynet_train"] = cold_k3
        step_ms = (pt_times["synthesis"] + pt_times["step"]) / PT_STEPS * 1e3
        emit("proxynet_train", t, batch=PT_BATCH, wh=PT_WH, iuv=True,
             lr=PT_LR, seed=PT_SEED, steps=PT_STEPS,
             first_step_card_vs_cpu=parity, loss=cold_curve,
             wall_s=round(cold_s, 4), ms_per_step=round(step_ms, 3),
             steps_per_s=round(1e3 / step_ms, 3),
             synthesis_share=round(pt_times["synthesis"]
                                   / (pt_times["synthesis"]
                                      + pt_times["step"]), 4),
             k3_share=round(sum(r["ms"] for r in k3_pt) / step_ms, 4),
             stage_s_synchronised={k: round(v, 4)
                                   for k, v in pt_times.items()},
             k3_launches=cold_k3, k3=[{k: r[k] for k in (
                 "b", "wh", "ms", "bound_ms", "plain_ms", "plain_b")}
                 for r in k3_pt],
             warm={"init": PN_WEIGHTS[256], "steps": WARM_STEPS,
                   "lr": WARM_LR, "wall_s": round(warm_s, 4),
                   "loss": curve(warm.history), "saved": "f16, compressed",
                   "metrics": {k: res_pw[k] for k in PN_METRICS},
                   "record": {k: pn_record[k] for k in PN_METRICS},
                   "record_rel_tol": RECORD_REL},
             nvidia_smi=smi)

        # -- detector_train: the detector on synthetic frames ---------------
        t = time.time()
        gen = torch.Generator().manual_seed(DT_SEED)
        fdraws = synth.sample_frame_draws(gen, DT_BATCH, DT_PLAYERS, DT_HW)
        fbatch = synth.render_frame_batch(assets, fdraws, DT_HW)
        dparity = first_step_gap(
            ptrain.new_detector(gen=torch.Generator().manual_seed(DT_SEED),
                                device="cpu"),
            fbatch, ptrain.make_detector_train_step)
        kw = dict(batch=DT_BATCH, hw=DT_HW, n_players=DT_PLAYERS,
                  log_every=0, device=dev)
        ptrain.train_detector_synth(assets, steps=1, seed=DT_SEED, **kw)
        dt_times = {}
        dcold, dcold_s, _, dcold_k3 = counted(
            lambda: ptrain.train_detector_synth(
                assets, steps=DT_STEPS, learning_rate=PT_LR, seed=DT_SEED,
                stage_times=dt_times, **kw))
        check(dcold_k3 == DT_STEPS, "detector training launched K3 %d times "
              "in %d steps" % (dcold_k3, DT_STEPS))
        dcurve = curve(dcold.history)
        falls(dcurve, "the detector from flax's initialisers")
        dwarm, dwarm_s, _, _ = counted(lambda: ptrain.train_detector_synth(
            assets, steps=WARM_STEPS, learning_rate=WARM_LR,
            seed=DT_SEED + 1, init_weights=os.path.join(root, DET_WEIGHTS),
            **kw))
        det_path = os.path.join(tmp, "detector_warm_f16.npz")
        ptrain.save_perception_weights(det_path, dwarm.model,
                                       dtype=np.float16, compress=True)
        res_dw = quality.evaluate_detector(
            load_detector_weights(det_path, dev), assets,
            n_batches=DET_BATCHES, batch=DET_BATCH, hw=DET_HW,
            n_players=DET_PLAYERS, device=dev)
        for k in DET_METRICS:
            check(abs(res_dw[k] - det_record[k]) <= RECORD_REL * det_record[k],
                  "warm-started detector %s %.4f is not within %d%% of the "
                  "record %.4f" % (k, res_dw[k], RECORD_REL * 100,
                                   det_record[k]))
        fscn = synth.frame_scene(assets, fdraws, DT_HW)
        k3_dt = dict(k3_case(fscn, DT_BATCH, fscn["wh"], 1.0,
                             K3_TRAIN_PLAIN_B), path="detector_train")
        k3_new.append(k3_dt)
        k3_paths["detector_train"] = dcold_k3
        dstep_ms = (dt_times["synthesis"] + dt_times["step"]) / DT_STEPS * 1e3
        emit("detector_train", t, batch=DT_BATCH, hw=list(DT_HW),
             players=DT_PLAYERS, lr=PT_LR, seed=DT_SEED, steps=DT_STEPS,
             min_visible_fill=ptrain.MIN_VISIBLE_FILL,
             first_step_card_vs_cpu=dparity, loss=dcurve,
             wall_s=round(dcold_s, 4), ms_per_step=round(dstep_ms, 3),
             steps_per_s=round(1e3 / dstep_ms, 3),
             synthesis_share=round(dt_times["synthesis"]
                                   / (dt_times["synthesis"]
                                      + dt_times["step"]), 4),
             k3_share=round(k3_dt["ms"] / dstep_ms, 4),
             stage_s_synchronised={k: round(v, 4)
                                   for k, v in dt_times.items()},
             k3_launches=dcold_k3, k3={k: k3_dt[k] for k in (
                 "b", "wh", "faces", "ms", "bound_ms", "plain_ms",
                 "plain_b")},
             warm={"init": DET_WEIGHTS, "steps": WARM_STEPS, "lr": WARM_LR,
                   "wall_s": round(dwarm_s, 4), "loss": curve(dwarm.history),
                   "saved": "f16, compressed",
                   "metrics": {k: res_dw[k] for k in DET_METRICS},
                   "record": {k: det_record[k] for k in DET_METRICS},
                   "record_rel_tol": RECORD_REL},
             nvidia_smi=smi)

        # -- classifier_train: the frame classifier's head -------------------
        t = time.time()
        (images, labels), ds_s, _, ds_k3 = counted(
            lambda: cls_script.build_dataset(assets, CLS_TRAIN_FRAMES,
                                             CLS_TRAIN_SEED, device=dev))
        _, feat_net = load_classifier_weights(os.path.join(root,
                                                           CLS_WEIGHTS), dev)
        feats, ft_s, _, _ = counted(lambda: cls_script.featurize(
            feat_net, images, dev))
        head0 = flax_init_(ClassifyNet(),
                           torch.Generator().manual_seed(CLS_TRAIN_SEED))
        first = {}
        for where in ("cpu", dev):
            head, hist = train_classifier(
                feats, labels, epochs=1, seed=CLS_TRAIN_SEED,
                head=copy.deepcopy(head0), device=where)
            first[str(where)] = (hist, {k: v.cpu() for k, v in
                                        head.state_dict().items()})
        cls_gap = max(float((first[str(dev)][1][k] - v).abs().max())
                      for k, v in first["cpu"][1].items())
        loss_gap = abs(first[str(dev)][0]["train_loss"][0]
                       - first["cpu"][0]["train_loss"][0])
        check(cls_gap <= CLS_TRAIN_TOL and loss_gap <= CLS_TRAIN_TOL
              and first[str(dev)][0]["val_acc"] == first["cpu"][0]["val_acc"],
              "the classifier's first epoch on the card vs the CPU: head %.3g,"
              " loss %.3g, val_acc %s / %s" % (
                  cls_gap, loss_gap, first[str(dev)][0]["val_acc"],
                  first["cpu"][0]["val_acc"]))
        (head, hist), tr_s, _, _ = counted(lambda: train_classifier(
            feats, labels, epochs=CLS_TRAIN_EPOCHS, seed=CLS_TRAIN_SEED,
            head=copy.deepcopy(head0), device=dev))
        check(np.isfinite(hist["train_loss"]).all()
              and hist["train_loss"][-1] < hist["train_loss"][0],
              "the classifier's loss does not fall: %s" % hist)
        k3_paths["classifier_dataset"] = ds_k3
        emit("classifier_train", t, frames=CLS_TRAIN_FRAMES,
             main_camera=int(labels.sum()), seed=CLS_TRAIN_SEED,
             features=CLS_WEIGHTS, epochs=CLS_TRAIN_EPOCHS,
             dataset_s=round(ds_s, 4), featurize_s=round(ft_s, 4),
             train_s=round(tr_s, 4),
             ms_per_epoch=round(tr_s / CLS_TRAIN_EPOCHS * 1e3, 3),
             first_epoch_card_vs_cpu={"head_max_abs": cls_gap,
                                      "loss_abs": loss_gap,
                                      "tol": CLS_TRAIN_TOL},
             train_loss=hist["train_loss"], val_acc=hist["val_acc"],
             k3_launches=ds_k3, record_run="scripts/train_classifier_torch.py"
             " (PERF.md)", nvidia_smi=smi)

        # -- real_data_train: the create-proxy scene as training crops -------
        t = time.time()
        recs = real_data.collect_proxy_examples(rgb_images, rgb_proxies)
        check(len(recs) > 0, "the create-proxy scene holds no example")
        rd_gen = torch.Generator().manual_seed(RD_SEED)

        def synth_fn(step):
            return synth.render_crop_batch(
                assets, synth.sample_crop_draws(rd_gen, RD_BATCH,
                                                image_wh=PT_WH), PT_WH,
                with_image=True)

        mix = real_data.mixed_batches(synth_fn, real_data.proxy_tree_batches(
            rgb_images, rgb_proxies, RD_BATCH, PT_WH, seed=RD_SEED),
            p_real=RD_P_REAL, seed=RD_SEED)
        cpu_mix = real_data.mixed_batches(
            lambda step: None, real_data.proxy_tree_batches(
                rgb_images, rgb_proxies, RD_BATCH, PT_WH, seed=RD_SEED),
            p_real=RD_P_REAL, seed=RD_SEED)
        rd_state = ptrain.make_perception_state(
            load_proxynet_weights(os.path.join(root, PN_WEIGHTS[256]), dev),
            WARM_LR)
        rd_step = ptrain.make_proxynet_train_step()
        sources, rd_losses = [], []

        def real_steps():
            for _ in range(RD_STEPS):
                b_ = next(mix)
                want = next(cpu_mix)
                real = isinstance(b_["image"], np.ndarray)
                check(real == (want is not None), "the card's mix and the "
                      "CPU's pick different sources")
                if real:
                    b_ = {k: torch.from_numpy(v).to(dev)
                          for k, v in b_.items()}
                    check(all(np.array_equal(b_[k].cpu().numpy(), v)
                              for k, v in want.items()),
                          "a real batch on the card differs from the CPU's")
                sources.append("real" if real else "synth")
                _, m = rd_step(rd_state, b_)
                rd_losses.append({k: float(v) for k, v in m.items()})

        _, rd_s, _, rd_k3 = counted(real_steps)
        check(all(np.isfinite(list(m.values())).all() for m in rd_losses),
              "a mixed-batch step's losses are not finite: %s" % rd_losses)
        check(rd_k3 == 2 * sources.count("synth"),
              "the mixed steps launched K3 %d times for %d synthetic batches"
              % (rd_k3, sources.count("synth")))
        k3_paths["real_data_train"] = rd_k3
        emit("real_data_train", t, examples=len(recs),
             with_iuv=sum("iuv" in r for r in recs), batch=RD_BATCH,
             wh=PT_WH, p_real=RD_P_REAL, seed=RD_SEED, steps=RD_STEPS,
             sources=sources, losses=rd_losses, wall_s=round(rd_s, 4),
             init=PN_WEIGHTS[256], lr=WARM_LR, k3_launches=rd_k3,
             nvidia_smi=smi)

        # -- extracted_train: extracted proxies, then a distillation step ----
        t = time.time()
        pn_ex = ProxyExtractor(pn_nets[256], wh=EX_WH, device=dev)
        failed = []

        class CountingExtractor:
            device = pn_ex.device

            def __call__(self, images_u8):
                out = pn_ex(images_u8)
                failed.append(sum(r[0] is None for r in out))
                return out

        xdraws = straps.sample_extracted_draws(
            torch.Generator().manual_seed(EX_SEED), EX_B, EX_WH,
            image_gen=torch.Generator(device=dev).manual_seed(EX_SEED))
        straps.extracted_regressor_batch(assets, CountingExtractor(), xdraws,
                                         wh=EX_WH, return_raw=True)
        raw, ex_s, _, ex_k3 = counted(lambda: straps.extracted_regressor_batch(
            assets, CountingExtractor(), xdraws, wh=EX_WH, return_raw=True))
        check(ex_k3 == 2, "the extracted batch launched K3 %d times" % ex_k3)
        xbatch, asm_s, _, _ = counted(lambda: straps.assemble_extracted_batch(
            raw, EX_WH, device=dev))
        check(tuple(xbatch["proxy"].shape) == (EX_B, 18, 256, 256)
              and bool(torch.isfinite(xbatch["proxy"]).all()),
              "the assembled proxy is not (B, 18, 256, 256) finite")
        xst = distill.make_train_state(load_regressor_weights(
            os.path.join(root, WEIGHTS), dev), learning_rate=DISTILL_LR)
        xstep = distill.make_train_step()
        xstep(xst, assets, xbatch)
        (_, xm, _), xs_s, _, _ = counted(lambda: xstep(xst, assets, xbatch))
        check(np.isfinite(float(xm["loss"])), "the distillation step on the "
              "extracted batch: loss %s" % xm["loss"])
        xscn = synth.crop_scene(assets, synth.draws_to(xdraws.crop, dev),
                                EX_WH)
        k3_new += [dict(k3_case(xscn, EX_B, wh_, scale, K3_TRAIN_PLAIN_B),
                        path="extracted_train")
                   for wh_, scale in ((EX_WH, 1.0), (EX_WH // 4, 0.25))]
        k3_paths["extracted_train"] = ex_k3
        emit("extracted_train", t, b=EX_B, wh=EX_WH, seed=EX_SEED,
             weights=PN_WEIGHTS[256], extraction_failures=failed[-1],
             extraction_ms_per_batch=round(ex_s * 1e3, 3),
             assemble_ms=round(asm_s * 1e3, 3),
             distill_step_ms=round(xs_s * 1e3, 3),
             distill_loss=float(xm["loss"]), k3_launches=ex_k3,
             nvidia_smi=smi)

        # -- baselines: HMR / SPIN predictions, fitted and evaluated --------
        t = time.time()
        views = stages._gather_views(os.path.join(tree, "images"),
                                     os.path.join(tree, "proxies"), True)
        by_player = {}
        for node, view in views:
            if node.scene == "scene0":
                by_player.setdefault(node.path, (node, []))[1].append(view)
        players = [(n, v[:TREE_VIEWS]) for n, v in by_player.values()
                   if len(v) >= TREE_VIEWS]
        sil_pv, j2d_pv = [], []
        for node, vs in players:
            s_i, j_i = stages.load_proxy_batch(os.path.join(
                tree, "proxies", node.game, node.scene, node.player), vs)
            sil_pv.append(s_i)
            j2d_pv.append(j_i)
        sil_pv, j2d_pv = np.stack(sil_pv), np.stack(j2d_pv)
        n_p, n_v = sil_pv.shape[:2]
        with torch.no_grad():
            pred = predict_smpl(load_regressor_weights(os.path.join(
                root, WEIGHTS), dev), assets,
                torch.from_numpy(sil_pv[:, 0]).to(dev),
                torch.from_numpy(j2d_pv[:, 0]).to(dev), device=dev)
        bdir = os.path.join(tmp, "baselines")
        os.makedirs(bdir)
        files = []
        for i in range(n_p):
            rot, bet, cam_ = (pred.pose_rotmats[i:i + 1].cpu().numpy(),
                              pred.betas[i:i + 1].cpu().numpy(),
                              pred.cam_wp[i:i + 1].cpu().numpy())
            if i % 2 == 0:
                aa = rotmat_to_axis_angle(pred.pose_rotmats[i]).cpu().numpy()
                path = os.path.join(bdir, "player%d.npy" % i)
                np.save(path, np.concatenate([cam_[0], aa.reshape(-1),
                                              bet[0]])[None])
            else:
                path = os.path.join(bdir, "player%d.npz" % i)
                np.savez(path, pred_rotmat=rot, pred_betas=bet,
                         pred_camera=cam_)
            files.append(path)
        preds = [baselines.load_baseline_prediction(p) for p in files]
        # Through axis-angle and back: the body joints' rotations within
        # BASE_HMR_TOL; the global orient of a body facing the camera lies
        # near theta = pi, where the log map (the JAX package's formula)
        # loses precision, so its gap is reported, not held.
        hmr_gap = {part: max(float(np.abs(
            preds[i]["pose_rotmats"][0, sl]
            - pred.pose_rotmats[i, sl].cpu().numpy()).max())
            for i in range(0, n_p, 2))
            for part, sl in (("body", slice(1, None)),
                             ("global_orient", slice(0, 1)))}
        check(hmr_gap["body"] <= BASE_HMR_TOL, "the HMR round trip moves a "
              "body joint's rotation by %.3g" % hmr_gap["body"])
        runs = {}

        def run(name, fn):
            out, s_, k12_, _ = counted(fn)
            check(k12_["band_raster_fwd"] > 0 and k12_["band_raster_bwd"] > 0,
                  "baselines %s launched K1/K2 %s" % (name, k12_))
            runs[name] = (out, s_, k12_)
            k12_paths["baselines_" + name] = k12_
            return out

        r2d = run("2d", lambda: baselines.evaluate_baseline_2d(
            assets, preds, sil_pv[:, 0], j2d_pv[:, 0], device=dev))
        r1v = run("oneview", lambda: baselines.evaluate_baseline_oneview(
            assets, preds, sil_pv[:, 1], j2d_pv[:, 1], device=dev))
        rcr = run("cross", lambda: baselines.evaluate_baseline_cross(
            assets, preds, sil_pv, j2d_pv, 0, 1, n_v, device=dev))
        rmv = {sv: run("multi_view_%s" % ("sv_init" if sv else "raw"),
                       lambda: baselines.multi_view_optimization_multi(
                           assets, preds, sil_pv, j2d_pv,
                           single_view_init=sv, device=dev))
               for sv in (True, False)}
        # Each prediction unfitted in every view: the multi-view fits' init.
        flat = [p for p in preds for _ in range(n_v)]
        init_mv = baselines.evaluate_baseline_2d(
            assets, flat, sil_pv.reshape((-1,) + sil_pv.shape[2:]),
            j2d_pv.reshape((-1,) + j2d_pv.shape[2:]), optimize=False,
            device=dev)
        mv_init = {"iou": float(init_mv["init_iou"].mean()),
                   "err": float(init_mv["init_err"].mean())}
        moved = {}
        for name, init_iou, init_err, iou, err in (
                ("2d", r2d["init_iou"], r2d["init_err"], r2d["opt_iou"],
                 r2d["opt_err"]),
                ("oneview", r1v["init_iou"], r1v["init_err"], r1v["opt_iou"],
                 r1v["opt_err"]),
                ("multi_view_sv_init", [mv_init["iou"]], [mv_init["err"]],
                 rmv[True]["silh_iou"], rmv[True]["joint_err"]),
                ("multi_view_raw", [mv_init["iou"]], [mv_init["err"]],
                 rmv[False]["silh_iou"], rmv[False]["joint_err"])):
            moved[name] = {"iou": [float(np.mean(init_iou)),
                                   float(np.mean(iou))],
                           "joint_err": [float(np.mean(init_err)),
                                         float(np.mean(err))]}
            check(moved[name]["iou"][1] > moved[name]["iou"][0]
                  and moved[name]["joint_err"][1]
                  < moved[name]["joint_err"][0],
                  "baselines %s: IoU %s and joint error %s from init to fit"
                  % (name, moved[name]["iou"], moved[name]["joint_err"]))
        check(np.isfinite(rcr["silh_iou"]).all()
              and np.isfinite(rcr["joint_err"]).all(),
              "the cross-view evaluation is not finite: %s" % rcr)
        # One player on the card against the CPU, a short joints-only fit.
        short = FitConfig(**BASE_CPU_KNOBS)
        one = {}
        for where in ("cpu", dev):
            one[str(where)] = baselines.evaluate_baseline_2d(
                assets.to(where), preds[:1], sil_pv[:1, 0], j2d_pv[:1, 0],
                fit_cfg=short, device=where)
        base_gap = max(
            max(float(np.abs(one[str(dev)][k] - one["cpu"][k]).max())
                for k in ("init_iou", "init_err", "opt_iou", "opt_err")),
            max(float((getattr(one[str(dev)]["result"], k).cpu()
                       - getattr(one["cpu"]["result"], k)).abs().max())
                for k in ("global_orient", "cam_wp")))
        check(base_gap <= BASE_CPU_TOL, "one baseline player, card vs CPU: "
              "%.3g" % base_gap)
        # K1/K2 at the baselines' rows: the players (2d, cross) and the
        # players' views (multi-view), the predictions' bodies at 512^2.
        mv_rows = rmv[True]["result"]
        for rows_name, bp, go, be, cm in (
                ("baselines_players", pred.pose_rotmats[:, 1:],
                 pred.pose_rotmats[:, :1], pred.betas, pred.cam_wp),
                ("baselines_views",
                 mv_rows.body_pose.repeat_interleave(n_v, 0),
                 mv_rows.global_orient.reshape(-1, 1, 3, 3),
                 mv_rows.betas.repeat_interleave(n_v, 0),
                 mv_rows.cam_wp.reshape(-1, 3))):
            with torch.no_grad():
                v2d = rows_verts2d(bp, go, be, cm, PROXY_WH)
            k12_new.append(dict(k12_case(v2d, PROXY_WH, BASE_K12_PLAIN_B),
                                path=rows_name))
        emit("baselines", t, players=n_p, views=n_v, wh=PROXY_WH,
             formats={"hmr_npy": (n_p + 1) // 2, "spin_npz": n_p // 2},
             hmr_round_trip_max_abs=hmr_gap,
             iters={"broad": cfg.BROAD_VIEW_ITERS,
                    "multi_view": [cfg.MULTI_VIEW_ROUNDS,
                                   cfg.MULTI_VIEW_ITERS]},
             wall_s={k: round(v[1], 4) for k, v in runs.items()},
             ms_per_iteration={
                 k: round(v[1] / max(v[2]["band_raster_fwd"], 1) * 1e3, 3)
                 for k, v in runs.items()},
             k1_k2_launches={k: v[2] for k, v in runs.items()},
             init_to_fit=moved,
             cross={"fit_view": 0, "eval_view": 1,
                    "silh_iou": float(rcr["silh_iou"].mean()),
                    "joint_err": float(rcr["joint_err"].mean())},
             one_player_card_vs_cpu={"max_abs": base_gap,
                                     "tol": BASE_CPU_TOL,
                                     "fit": BASE_CPU_KNOBS},
             k12=[{k: r[k] for k in ("path", "b", "wh", "ms", "bound_ms",
                                     "plain_ms", "plain_b")}
                  for r in k12_new[-2:]], nvidia_smi=smi)

        # -- cli_train_perception: train-perception as subprocesses ---------
        t = time.time()
        cli_runs = {}
        for kind, loader in (("proxynet", load_proxynet_weights),
                             ("detector", load_detector_weights)):
            out_path = os.path.join(tmp, "cli_%s.npz" % kind)
            line, wall = cli("train-perception", "--out", out_path,
                             "--model", kind, "--steps", str(CLI_PT_STEPS))
            check(line == {"weights": out_path, "steps": CLI_PT_STEPS},
                  "train-perception printed %s" % line)
            net = loader(out_path, dev)
            check(all(bool(torch.isfinite(v).all())
                      for v in net.state_dict().values()
                      if v.is_floating_point()),
                  "the CLI's %s weights are not finite" % kind)
            cli_runs[kind] = {"wall_s": wall, "steps": CLI_PT_STEPS}
        emit("cli_train_perception", t, runs=cli_runs, nvidia_smi=smi)
        return k12_paths, k3_paths, k12_new, k3_new

    def driver_phases(work: str):
        """The training drivers (``scripts/train_perception_torch.py``) in
        this process: the r05 fine-tune cut short, the same run as resumed
        segments, the r05 weights' evaluations and a ProxyNet drive.
        Returns the K3 launches by path and K3's new shapes."""
        import warnings
        k3_paths, k3_new = {}, []
        tmp = os.path.join(work, "driver")
        warm = os.path.join(tmp, "warm")
        os.makedirs(warm)
        shutil.copyfile(os.path.join(root, WEIGHTS),
                        os.path.join(warm, "weights_last.npz"))
        cache = os.path.join(tmp, "cache")

        def r05_argv(mode, ckpt):
            return [mode, "--via-proxynet", os.path.join(root, PN_WEIGHTS[256]),
                    "--finetune-from", warm, "--batch", str(TPD_BATCH),
                    "--wh", str(TPD_WH), "--lr", str(TPD_LR),
                    "--steps", str(TPD_STEPS), "--segment", str(TPD_SEGMENT),
                    "--extract-cache", cache, "--extract-batches",
                    str(TPD_EXTRACT_BATCHES), "--eval-batches",
                    str(TPD_EVAL_BATCHES), "--log-every", "1",
                    "--ckpt-dir", ckpt, "--device", DEVICE]

        def read_log(ckpt):
            with open(os.path.join(ckpt, "log.jsonl")) as f:
                return [json.loads(line) for line in f]

        def npz(path):
            with np.load(path) as z:
                return {k: z[k] for k in z.files}

        # Deterministic algorithms, warning (not raising) where an op has
        # none; the warnings name such ops.
        with warnings.catch_warnings(record=True) as nondet:
            warnings.simplefilter("always")
            os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                # -- (a) drive-regressor: the r05 recipe, cut ------------
                t = time.time()
                ckpt_a = os.path.join(tmp, "drive")
                args_a = tp_script.parse_args(r05_argv("drive-regressor",
                                                       ckpt_a))
                split_a = {}
                rc_a, drive_s, _, drive_k3 = counted(
                    lambda: tp_script.drive(args_a, "regressor",
                                            stage_times=split_a))
                log_a = read_log(ckpt_a)
                steps_a = [r for r in log_a if r["kind"] == "regressor"]
                evals_a = [r for r in log_a if r["kind"] == "eval-regressor"]
                check(rc_a == 0 and [r["step"] for r in steps_a]
                      == list(range(1, TPD_STEPS + 1))
                      and all(np.isfinite(r["total"]) for r in steps_a),
                      "drive-regressor: rc %s, steps %s" % (rc_a, steps_a))
                check(len(evals_a) == TPD_STEPS // TPD_SEGMENT
                      and all(np.isfinite(r["pve_mm"]) for r in evals_a),
                      "drive-regressor logged %d evaluations: %s"
                      % (len(evals_a), evals_a))
                check(all(os.path.isfile(os.path.join(ckpt_a, f)) for f in (
                    "best.json", "weights_best.npz", "state.npz",
                    "weights_last.npz")), "drive-regressor: files missing")
                picks = [bool(tp_script.use_extracted(0, i, args_a.p_real))
                         for i in range(TPD_STEPS)]
                slots = {i % TPD_EXTRACT_BATCHES
                         for i in range(TPD_STEPS) if picks[i]}
                # Two K3 passes (256^2, 64^2) per synthetic batch, per
                # cache fill and per evaluation batch.
                want_k3 = 2 * (picks.count(False) + len(slots)
                               + len(evals_a) * TPD_EVAL_BATCHES)
                check(drive_k3 == want_k3, "drive-regressor launched K3 %d "
                      "times, its batches need %d" % (drive_k3, want_k3))
                k3_paths["train_perception_drive"] = drive_k3
                train_s = split_a.get("batch", 0.0) + split_a.get("step", 0.0)
                emit("train_perception_drive", t, argv=r05_argv(
                    "drive-regressor", "<ckpt>")[1:], rc=rc_a,
                    wall_s=round(drive_s, 4),
                    ms_per_step=round(train_s / TPD_STEPS * 1e3, 3),
                    split_s={k: round(v, 4) for k, v in split_a.items()},
                    extracted_steps=[i for i in range(TPD_STEPS)
                                     if picks[i]],
                    losses=[r["total"] for r in steps_a],
                    evals=[{k: r[k] for k in ("pve_mm", "mpjpe_pa_mm",
                                              "n_images")}
                           for r in evals_a],
                    k3_launches=drive_k3, nvidia_smi=smi)

                # -- (b) the same run as two resumed segments -------------
                t = time.time()
                ckpt_b = os.path.join(tmp, "segments")
                args_b = tp_script.parse_args(r05_argv("regressor", ckpt_b))
                split_b = {}
                rcs, seg_s, _, seg_k3 = counted(lambda: [
                    tp_script.train_segment(args_b, "regressor",
                                            stage_times=split_b)
                    for _ in range(2)])
                check(rcs == [tp_script.SEGMENT_RC, 0],
                      "the segments returned %s" % rcs)
                gaps = {}
                for name in ("state.npz", "weights_last.npz"):
                    a_, b_ = (npz(os.path.join(c, name))
                              for c in (ckpt_a, ckpt_b))
                    check(set(a_) == set(b_), "%s: keys differ" % name)
                    gaps[name] = max(float(np.abs(
                        a_[k].astype(np.float64)
                        - b_[k].astype(np.float64)).max()) for k in a_)
                check(all(v == 0.0 for v in gaps.values()),
                      "the resumed segments differ from the drive: %s"
                      % gaps)
                check(seg_k3 == 2 * picks.count(False),
                      "the segments launched K3 %d times for %d synthetic "
                      "batches (the cache replays)" % (seg_k3,
                                                        picks.count(False)))
                k3_paths["train_perception_segments"] = seg_k3
                seg_train_s = (split_b.get("batch", 0.0)
                               + split_b.get("step", 0.0))
                emit("train_perception_resume", t, rcs=rcs,
                     wall_s=round(seg_s, 4),
                     ms_per_step=round(seg_train_s / TPD_STEPS * 1e3, 3),
                     max_abs_vs_drive=gaps, k3_launches=seg_k3,
                     nondeterministic_ops=sorted({str(w.message)[:160]
                                                  for w in nondet}),
                     nvidia_smi=smi)
            finally:
                torch.use_deterministic_algorithms(False)

        # -- (c) the r05 weights against their records --------------------
        t = time.time()
        r05 = {}
        for arm in ("clean", "e2e"):
            with open(os.path.join(root, R05_RECORDS[arm])) as f:
                record = json.load(f)
            argv = ["eval-regressor", "--weights",
                    os.path.join(root, R05_WEIGHTS), "--wh", str(R05_WH[arm]),
                    "--batch", str(R05_BATCH), "--eval-batches",
                    str(R05_BATCHES), "--device", DEVICE]
            if arm == "e2e":
                argv += ["--via-proxynet", os.path.join(root, PN_WEIGHTS[256])]
            res, s_, _, n3 = counted(lambda: tp_script.eval_regressor(
                tp_script.parse_args(argv)))
            check(n3 == 2 * R05_BATCHES, "the r05 %s evaluation launched "
                  "K3 %d times" % (arm, n3))
            for k in R05_METRICS:
                check(np.isfinite(res[k]) and abs(res[k] - record[k])
                      <= RECORD_REL * record[k],
                      "r05 %s %s %.4g is not within %d%% of the record %.4g"
                      % (arm, k, res[k], RECORD_REL * 100, record[k]))
            k3_paths["r05_%s_eval" % arm] = n3
            r05[arm] = {"wall_s": round(s_, 4), "n_images": res["n_images"],
                        "wh": R05_WH[arm], "k3_launches": n3,
                        "metrics": {k: res[k] for k in R05_METRICS},
                        "record": {k: record[k] for k in R05_METRICS},
                        "rel": {k: (res[k] - record[k]) / record[k]
                                for k in R05_METRICS}}
            if arm == "e2e":
                r05[arm]["extraction_failures"] = res["extraction_failures"]
        emit("r05_eval", t, weights=R05_WEIGHTS, arms=r05,
             record_rel_tol=RECORD_REL, nvidia_smi=smi)

        # -- (d) drive-proxynet from flax's initialisers ------------------
        t = time.time()
        ckpt_d = os.path.join(tmp, "proxynet")
        args_d = tp_script.parse_args([
            "drive-proxynet", "--steps", str(PND_STEPS), "--segment",
            str(PND_SEGMENT), "--batch", str(PND_BATCH), "--wh", str(PND_WH),
            "--eval-batches", "1", "--log-every", "1", "--ckpt-dir", ckpt_d,
            "--device", DEVICE])
        split_d = {}
        rc_d, pn_s, _, pn_k3 = counted(lambda: tp_script.drive(
            args_d, "proxynet", stage_times=split_d))
        log_d = read_log(ckpt_d)
        steps_d = [r for r in log_d if r["kind"] == "proxynet"]
        evals_d = [r for r in log_d if r["kind"] == "eval-proxynet"]
        check(rc_d == 0 and len(steps_d) == PND_STEPS
              and all(np.isfinite(r["total"]) for r in steps_d),
              "drive-proxynet: rc %s, steps %s" % (rc_d, steps_d))
        check(len(evals_d) == PND_STEPS // PND_SEGMENT
              and all("kp_pck@0.10bbox" in r and "mask_mean_iou" in r
                      for r in evals_d),
              "drive-proxynet logged %d evaluations: %s" % (len(evals_d),
                                                            evals_d))
        check(pn_k3 == 2 * (PND_STEPS + len(evals_d)),
              "drive-proxynet launched K3 %d times" % pn_k3)
        k3_paths["train_perception_proxynet"] = pn_k3
        scores = [tp_script.score("proxynet", r) for r in evals_d]
        emit("train_perception_proxynet", t, rc=rc_d,
             wall_s=round(pn_s, 4),
             ms_per_step=round((split_d.get("batch", 0.0)
                                + split_d.get("step", 0.0))
                               / PND_STEPS * 1e3, 3),
             split_s={k: round(v, 4) for k, v in split_d.items()},
             losses=[r["total"] for r in steps_d], scores=scores,
             best=os.path.isfile(os.path.join(ckpt_d, "best.json")),
             k3_launches=pn_k3, nvidia_smi=smi)

        # -- the relation script: train, and relate on the mint tree -----
        t = time.time()
        rel_dir = os.path.join(tmp, "relation")
        res_tr, tr_s, _, _ = counted(lambda: tr_script.cmd_train(
            tr_script.parse_args(["train", "--steps", str(RS_STEPS),
                                  "--eval-batches", str(RS_EVAL_BATCHES),
                                  "--out-dir", rel_dir, "--device",
                                  DEVICE])))
        check(np.isfinite(res_tr["mse_out"]) and os.path.isfile(
            os.path.join(rel_dir, "relation_v0.npz")),
              "train_relation_torch.py train: %s" % res_tr)
        res_rel, rel_s, _, _ = counted(lambda: tr_script.cmd_relate(
            tr_script.parse_args(["relate", "--root",
                                  os.path.join(work, "mint"), "--out-dir",
                                  rel_dir, "--device", DEVICE])))
        arms = ("without_relation", "with_relation")
        check(all(np.isfinite(v) for a in arms for v in res_rel[a].values()
                  if isinstance(v, float))
              and res_rel["without_relation"].get("num_players", 0) > 0,
              "train_relation_torch.py relate: %s" % res_rel)
        emit("relation_script", t, steps=RS_STEPS,
             train_wall_s=round(tr_s, 4), mse_in=res_tr["mse_in"],
             mse_out=res_tr["mse_out"], relate_wall_s=round(rel_s, 4),
             players=res_rel["without_relation"].get("num_players"),
             nvidia_smi=smi)

        # -- (e) K3 at the regressor's synthetic batch (256^2, B = 16) ----
        t = time.time()
        gen, _ = tp_script.step_generators(0, 0, dev)
        rdraws = straps.sample_regressor_draws(gen, TPD_BATCH, TPD_WH)
        rscn = synth.crop_scene(assets, synth.draws_to(rdraws.crop, dev),
                                TPD_WH)
        k3_new += [dict(k3_case(rscn, TPD_BATCH, wh_, scale,
                                K3_DRIVER_PLAIN_B), path="train_perception")
                   for wh_, scale in ((TPD_WH, 1.0), (TPD_WH // 4, 0.25))]
        emit("k3_train_perception", t, shapes=[
            {k: r[k] for k in ("b", "wh", "ms", "plain_b", "plain_ms",
                               "bound_ms", "w_max_abs")}
            for r in k3_new], nvidia_smi=smi)
        return {}, k3_paths, [], k3_new

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

    work = tempfile.mkdtemp(prefix="_smoke_", dir=root)
    _WORK_DIRS.append(work)
    try:
        for phases in (lambda: tree_phases(work),
                       lambda: clip_phases(
                           work, os.path.join(work, "rgb", "images")),
                       lambda: train_phases(work),
                       lambda: perception_phases(work),
                       lambda: driver_phases(work)):
            phases = phases()
            k12_launches.update(phases[0])
            k3_fit_launches.update(phases[1])
            k12 += phases[2]
            k3 += phases[3]
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # == Texture, the attribute renders, the IUV proxies, relation =========
    from soccerplayershapepose_torch.convert import load_relation_weights
    from soccerplayershapepose_torch.texture import quality as tex_q
    from soccerplayershapepose_torch.texture import uv as tex_uv
    from soccerplayershapepose_torch.train import relation as rel_mod
    with open(os.path.join(root, TEX_RECORD)) as f:
        tex_record = json.load(f)

    # -- texture_quality: the texture probe, GT vs predicted IUV atlases ----
    t = time.time()
    tex_s = {}
    res_tex, tex_wall, _, k3_launches_tex = counted(
        lambda: tex_q.texture_quality(
            pn_nets[TEX_WH], assets, n_batches=TEX_BATCHES, batch=TEX_BATCH,
            wh=TEX_WH, seed=TEX_SEED, stage_times=tex_s, device=dev))
    check(k3_launches_tex == 2 * TEX_BATCHES,
          "K3 launched %d times in %d texture batches"
          % (k3_launches_tex, TEX_BATCHES))
    atlas, atlas_mask = res_tex.pop("pred_atlas"), res_tex.pop(
        "pred_atlas_mask")
    check(res_tex["n_crops"] == TEX_BATCHES * TEX_BATCH
          and all(np.isfinite(v) for v in res_tex.values()),
          "texture probe: %s" % res_tex)
    for k in TEX_METRICS:
        check(abs(res_tex[k] - tex_record[k]) <= RECORD_REL * tex_record[k],
              "texture %s %.4f is not within %d%% of the record %.4f"
              % (k, res_tex[k], RECORD_REL * 100, tex_record[k]))
    # The predicted atlas of the probe's first batch, fused over its crops,
    # is the texture of the textured render below.
    sheet = tex_uv.concat_atlas(atlas)
    check(torch.equal(tex_uv.split_atlas(sheet), atlas),
          "split_atlas does not invert concat_atlas")
    normal_map = tex_uv.atlas_to_normal(tex_uv.split_atlas(sheet),
                                        normal_res=ATTR_NORMAL_RES)
    emit("texture_quality", t, n_crops=res_tex["n_crops"], wh=TEX_WH,
         grid=res_tex["grid"], weights=PN_WEIGHTS[TEX_WH],
         wall_s=round(tex_wall, 4), k3_launches=k3_launches_tex,
         stage_s_synchronised={k: round(v, 4) for k, v in tex_s.items()},
         metrics={k: v for k, v in res_tex.items() if isinstance(v, float)},
         record={k: tex_record[k] for k in TEX_METRICS + (
             "coverage_gt", "coverage_pred", "coverage_inter")},
         record_rel_tol=RECORD_REL,
         fused_atlas_coverage=float(atlas_mask.mean()), nvidia_smi=smi)

    # -- attr_render: part segmentation and textured render through K3 -------
    # B = 2 crops at 512^2, each a player and its occluder (both present),
    # 2 x 13,776 faces. Part labels are DensePose ids (vertex part + 1, 25
    # classes); the texture is the fused predicted atlas's normal map.
    t = time.time()
    ad = synth.sample_crop_draws(torch.Generator().manual_seed(ATTR_SEED),
                                 ATTR_B)
    ad = ad._replace(occluder=ad.occluder._replace(
        present=torch.ones_like(ad.occluder.present)))
    ascn = synth.crop_scene(assets, synth.draws_to(ad, dev), ATTR_WH)
    v2d, vz, afaces = ascn["verts2d"], ascn["verts_z"], ascn["faces"]
    n_bodies = v2d.shape[1] // assets.v_template.shape[0]
    parts = (synth.vertex_parts(assets) + 1).repeat(n_bodies)
    vuv = synth.vertex_uv(assets).repeat(n_bodies, 1)

    def attr_renders():
        return (attribute.render_part_segmentation(
                    v2d, vz, parts, afaces, ATTR_WH, num_parts=ATTR_PARTS),
                attribute.render_textured(v2d, vz, vuv, afaces, normal_map,
                                          ATTR_WH))

    attr_renders()
    (labels_k, (img_k, mask_k)), attr_wall, _, k3_launches_attr = counted(
        attr_renders)
    check(k3_launches_attr == 2, "the two renders launched K3 %d times"
          % k3_launches_attr)
    # One plain call for both renders: one-hot parts, UV and the depth.
    onehot = torch.nn.functional.one_hot(parts.long(), ATTR_PARTS).float()
    a_in = torch.cat([onehot, vuv], -1)[None].expand(ATTR_B, -1, -1)
    a_in = torch.cat([a_in, vz[..., None]], -1)
    a_k, m_k = attribute.rasterize_attributes(v2d, vz, a_in, afaces, ATTR_WH)
    torch.cuda.synchronize()
    t_p = time.time()
    a_p, m_p = attribute.rasterize_attributes_plain(v2d, vz, a_in, afaces,
                                                    ATTR_WH)
    torch.cuda.synchronize()
    attr_plain_s = time.time() - t_p
    check(torch.equal(mask_k, m_p) and torch.equal(m_k, m_p)
          and torch.equal(labels_k > 0, m_p),
          "the renders' masks differ from the plain route's")
    labels_p = torch.where(m_p, torch.argmax(a_p[..., :ATTR_PARTS], -1), 0)
    img_p = tex_uv.sample_uv_texture(
        normal_map, a_p[..., ATTR_PARTS:ATTR_PARTS + 2].reshape(-1, 2)
    ).reshape(img_k.shape) * m_p[..., None]
    # Near-ties: the top two one-hot weights within ATTR_TIE_W on either
    # route, or another face at a depth within K3_TIE_ULPS.
    weight_tie = torch.zeros_like(m_p)
    for a in (a_k, a_p):
        top2 = torch.topk(a[..., :ATTR_PARTS], 2, dim=-1).values
        weight_tie |= (top2[..., 0] - top2[..., 1]) <= ATTR_TIE_W
    z_k, z_p = a_k[..., -1], a_p[..., -1]
    other_face = (a_k[..., :-1] - a_p[..., :-1]).abs().amax(-1) > K3_ATTR_TOL
    depth_tie = other_face & m_p & ((z_k - z_p).abs() <= K3_TIE_ULPS * ulp(
        torch.maximum(z_k.abs(), z_p.abs())))
    labels_apart = labels_k != labels_p
    check(bool((~labels_apart | weight_tie | depth_tie).all()),
          "part labels differ from the plain route at %d pixels that are no "
          "near-tie" % int((labels_apart & ~weight_tie & ~depth_tie).sum()))
    check(not bool((other_face & m_p & ~depth_tie).any()),
          "the routes take faces of different depth at %d pixels"
          % int((other_face & m_p & ~depth_tie).sum()))
    # The image off the depth ties: within ATTR_IMG_TOL, except where the
    # two routes' UV gap (each within K3_ATTR_TOL) times the normal map's
    # steepest texel step and size bounds a larger gap.
    uv_gap = (a_k[..., ATTR_PARTS:ATTR_PARTS + 2]
              - a_p[..., ATTR_PARTS:ATTR_PARTS + 2]).abs().amax(-1)
    img_gap = (img_k - img_p).abs().amax(-1)
    step = max(float(normal_map.diff(dim=0).abs().max()),
               float(normal_map.diff(dim=1).abs().max()))
    slope = (normal_map.shape[0] + normal_map.shape[1] - 2) * step
    off = m_p & ~depth_tie
    steep = off & (img_gap > ATTR_IMG_TOL)
    check(bool((uv_gap[off] <= K3_ATTR_TOL).all()),
          "the routes' UVs differ by %.3g on the same face"
          % float(uv_gap[off].max()))
    check(bool((img_gap[steep] <= ATTR_IMG_TOL + slope * uv_gap[steep]).all()),
          "the textured image differs beyond its UV gap at %d pixels"
          % int((steep & (img_gap > ATTR_IMG_TOL + slope * uv_gap)).sum()))
    check(bool(torch.isfinite(img_k).all()) and labels_k.max() < ATTR_PARTS,
          "the renders are not finite labels and colours")
    k3_attr = dict(k3_case(ascn, ATTR_B, ATTR_WH, 1.0), path="attr_render")
    emit("attr_render", t, b=ATTR_B, wh=ATTR_WH,
         faces=int(afaces.shape[0]), parts=ATTR_PARTS,
         normal_res=ATTR_NORMAL_RES, wall_ms=round(attr_wall * 1e3, 3),
         k3_launches=k3_launches_attr, covered_px=int(m_p.sum()),
         labels_apart=int(labels_apart.sum()),
         weight_tie_px=int((labels_apart & weight_tie).sum()),
         depth_tie_px=int(depth_tie.sum()),
         uv_max_abs=float(uv_gap[off].max()),
         img_max_abs_off_ties=float(img_gap[off].max()),
         img_tol=ATTR_IMG_TOL, steep_texel_px=int(steep.sum()),
         texture_slope=slope, plain_route_s=round(attr_plain_s, 4),
         k3_ms=k3_attr["ms"], k3_bound_ms=k3_attr["bound_ms"],
         k3_bound_by=k3_attr["bound_by"],
         k3_pairs_evaluated=k3_attr["pairs_evaluated"],
         k3_padded_box_pairs=k3_attr["padded_box_pairs"],
         k3_support_pairs=k3_attr["support_pairs"],
         k3_plain_ms=k3_attr["plain_ms"], nvidia_smi=smi)
    k3.append(k3_attr)

    # -- iuv_eval: the 20- and 21-channel proxies from the expanded weights --
    t = time.time()
    iuv_dir = tempfile.mkdtemp(prefix="_smoke_iuv_", dir=root)
    _WORK_DIRS.append(iuv_dir)
    try:
        iuv_models = {}
        for c in (20, 21):
            path = os.path.join(iuv_dir, "regressor_%dch.npz" % c)
            straps.expand_regressor_channels(os.path.join(root, WEIGHTS),
                                             path, c)
            iuv_models[c] = load_regressor_weights(path, dev)
    finally:
        shutil.rmtree(iuv_dir, ignore_errors=True)
    check(all(iuv_models[c].in_channels == c for c in (20, 21)),
          "the expanded regressors' input widths")

    # synth_eval's ``res`` is the 18-channel regressor on the same draws.
    res21, iuv21_s, _, k3_launches_iuv = counted(
        lambda: straps.evaluate_regressor(
            iuv_models[21], assets, n_batches=EVAL_BATCHES, batch=EVAL_BATCH,
            wh=EVAL_WH, seed=EVAL_SEED, device=dev))
    check(k3_launches_iuv == 2 * EVAL_BATCHES,
          "K3 launched %d times in the 21-channel evaluation"
          % k3_launches_iuv)
    iuv_rel = {k: abs(res21[k] - res[k]) / abs(res[k]) for k in metrics}
    check(max(iuv_rel.values()) <= IUV_REL,
          "the 21-channel expansion disagrees with the 18-channel regressor: "
          "%s" % iuv_rel)
    e2e_iuv, k3_launches_e2e_iuv = {}, {}
    for c in (20, 21):
        r, s_, _, n3 = counted(lambda: straps.evaluate_regressor_e2e(
            iuv_models[c], ProxyExtractor(pn_nets[E2E_WH], wh=E2E_WH,
                                          device=dev), assets,
            n_batches=E2E_BATCHES, batch=E2E_BATCH, wh=E2E_WH,
            seed=EVAL_SEED, device=dev))
        check(n3 == 2 * E2E_BATCHES, "K3 launched %d times in the %d-channel "
              "e2e evaluation" % (n3, c))
        check(r["n_images"] > 0 and all(np.isfinite(r[k]) for k in metrics),
              "%d-channel e2e metrics missing or not finite: %s" % (c, r))
        e2e_iuv[c] = dict({k: r[k] for k in metrics}, wall_s=round(s_, 4),
                          n_images=r["n_images"],
                          extraction_failures=r["extraction_failures"])
        k3_launches_e2e_iuv[c] = n3
    emit("iuv_eval", t, wh=EVAL_WH, n_images=res21["n_images"],
         wall_s_21ch=round(iuv21_s, 4), k3_launches=k3_launches_iuv,
         rel_tol=IUV_REL, rel_21_vs_18=iuv_rel,
         metrics_21ch={k: res21[k] for k in metrics},
         metrics_18ch={k: res[k] for k in metrics},
         e2e_wh=E2E_WH, e2e=e2e_iuv, e2e_k3_launches=k3_launches_e2e_iuv,
         nvidia_smi=smi)

    # -- relation_eval: v0 and v1 with their committed weights ---------------
    t = time.time()
    rel_rows = {}
    for v in (0, 1):
        with open(os.path.join(root, REL_RECORDS[v])) as f:
            rel_record = json.load(f)
        rel_path = os.path.join(root, REL_WEIGHTS[v])
        rel_gpu = load_relation_weights(rel_path, dev)
        res_rel, rel_s, _, _ = counted(lambda: rel_mod.evaluate_relation(
            rel_gpu, assets, n_batches=REL_BATCHES, b=REL_B,
            n_players=REL_PLAYERS, seed=REL_SEED, device=dev))
        for k in ("mse", "angle", "mpjpe"):
            k_in, k_out = [k2 for k2 in res_rel if k2.startswith(k + "_")]
            check(np.isfinite(res_rel[k_out])
                  and res_rel[k_out] < res_rel[k_in],
                  "relation v%d %s: out %.4g is not below in %.4g"
                  % (v, k, res_rel[k_out], res_rel[k_in]))
            check(abs(res_rel[k_out] - rel_record[k_out])
                  <= RECORD_REL * rel_record[k_out],
                  "relation v%d %s %.4g is not within %d%% of the record "
                  "%.4g" % (v, k_out, res_rel[k_out], RECORD_REL * 100,
                            rel_record[k_out]))
        # The card against the CPU on one identical batch.
        draws = rel_mod.sample_relation_draws(
            torch.Generator().manual_seed(REL_SEED), REL_B, REL_PLAYERS)
        batch = rel_mod.synth_relation_batch(draws)
        batch_gpu = rel_mod.synth_relation_batch(draws, device=dev)
        rel_cpu = load_relation_weights(rel_path, "cpu")
        with torch.no_grad():
            ref = rel_cpu(batch["rotmats_noisy"], batch["boxes"],
                          batch["mask"])
            got = rel_gpu(batch["rotmats_noisy"].to(dev),
                          batch["boxes"].to(dev), batch["mask"].to(dev))
        rel_err = float((got.cpu() - ref).abs().max())
        check(rel_err <= REL_TOL, "relation v%d on the card disagrees with "
              "the CPU by %.3g" % (v, rel_err))
        rel_rows["v%d" % v] = {
            "metrics": res_rel, "wall_s": round(rel_s, 4),
            "scenes_per_s": round(res_rel["n_scenes"] / rel_s, 2),
            "record": {k: rel_record[k] for k in res_rel if k in rel_record},
            "card_vs_cpu_max_abs": rel_err,
            "batch_card_vs_cpu_max_abs": float(
                (batch_gpu["rotmats_noisy"].cpu()
                 - batch["rotmats_noisy"]).abs().max())}
    emit("relation_eval", t, batches=REL_BATCHES, scenes=REL_B,
         players=REL_PLAYERS, seed=REL_SEED, tol=REL_TOL,
         tf32=torch.backends.cuda.matmul.allow_tf32,
         record_rel_tol=RECORD_REL, variants=rel_rows, nvidia_smi=smi)

    # == The data- and model-parallel layer ==================================
    par_k12, par_k3 = parallel_phase(pair, assets, dev, counted, smi)
    k12_launches.update(par_k12)
    k3_fit_launches.update(par_k3)

    kernels = []
    # K1 and K2 run once per fit iteration (K1 alone in a forward-only
    # evaluation) on the 22-player fit, the three GT-3D evaluations, the
    # broadcast-view fit (with the multi-view fit its pose comes from),
    # the track bench, the mint chain of stages, the single-view stage at
    # its defaults on the tree and on the clip, the self-supervised
    # trainer and the five baseline evaluations. Their times are the mean per
    # launch over the path shapes of "shapes" (the plain versions' on
    # plain_b of the b rows), their pairs the sum over them.
    for name, line in (("band_raster_fwd", 33), ("band_raster_bwd", 475)):
        by_path = {p: n[name] for p, n in k12_launches.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "soccerplayershapepose_torch/csrc/band_raster.cu",
            "replaces": "soccerplayershapepose_tpu/render/pallas_raster.py:%d"
                        % line,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs"][name] for r in k12),
            "ms": sum(r["ms"][name] for r in k12) / len(k12),
            "plain_ms": sum(r["plain_ms"][name] for r in k12) / len(k12),
            "bound_ms": sum(r["bound_ms"][name] for r in k12) / len(k12),
            "bound_by": ("operations" if all(
                r["bound_by"][name] == "operations" for r in k12)
                else "bytes"),
            "library_ms": None,
            "support_pairs": sum(r["support_pairs"] for r in k12),
            "pairs_evaluated": sum(r["pairs_evaluated"][name] for r in k12),
            "shapes": [{
                "path": r["path"], "b": r["b"], "wh": r["wh"],
                "ms": r["ms"][name], "plain_b": r["plain_b"],
                "plain_ms": r["plain_ms"][name],
                "bound_ms": r["bound_ms"][name],
                "support_pairs": r["support_pairs"],
                "pairs_evaluated": r["pairs_evaluated"][name],
                "bound_ms_chunk_level": r["bound_ms_chunk_level"][name]}
                for r in k12]})
    # K3 runs once at each pass shape per batch, on fourteen paths: the
    # synthetic evaluation and ProxyNet's at 512² (512² and 128² passes),
    # the e2e evaluation and ProxyNet's at 256² (256² and 64²), the
    # detector's evaluation (one 448² pass per batch of 16 frames), the
    # frame pipeline's synthesis (one 896² pass for its 2 frames), the
    # single-view GT-3D evaluation's crops (512², 128²), the scene
    # renders (one 512² pass per view, or per track batch) of the
    # multi-view and track evaluations, the broadcast-view fit, the
    # stage tree and the create-proxy scene (with colour channels), the
    # one clip's synthesis (448² per pair of wide frames, 256² and 64² per
    # pair of close-ups), the texture probe's crops (256², 64²), the
    # part-segmentation and textured renders (one 512² pass each for a
    # player and its occluder, B = 2) and the 20- and 21-channel
    # evaluations (512² and 128², or 256² and 64²), and the perception
    # trainers' synthesis inside every step (ProxyNet: 256² and 64²,
    # B = 8; the detector: 448², B = 4), the classifier's dataset, the
    # mixed real and synthetic batches and the extracted batch (256² and
    # 64², B = 16), and the training drivers' steps, cache fills and
    # evaluations (256² and 64² at B = 16 and 8, 512² and 128²). Its
    # times are the mean per launch over the pass shapes, its pairs the
    # sum over them; "shapes" gives each (the plain version's time on
    # plain_b of the b images), "launches_by_path" each path's count.
    k3_by_path = {"synth_eval": k3_launches, "e2e_eval": k3_launches_e2e,
                  "detector_eval": k3_launches_det,
                  "frame_pipeline_synthesis": k3_launches_frame,
                  **k3_fit_launches}
    k3_by_path.update({"proxynet_eval_%d" % wh: n
                       for wh, n in k3_launches_pn.items()})
    k3_by_path.update({"texture_quality": k3_launches_tex,
                       "attr_render": k3_launches_attr,
                       "iuv_eval_21ch": k3_launches_iuv})
    k3_by_path.update({"iuv_e2e_%dch" % c: n
                       for c, n in k3_launches_e2e_iuv.items()})
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
