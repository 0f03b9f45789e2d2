#!/usr/bin/env python3
"""Where the time of the band kernels K1/K2 goes, on one CUDA card.

    python3 scripts/probe_band_kernels.py

Builds ``soccerplayershapepose_torch/csrc/band_raster.cu`` as it is and in
variants with parts of the work cut out, and times each at the fit shape of
``chip_smoke.py`` (22 players, 256², σ = 1e-5) with CUDA events:

* ``k1``: K1 as shipped;
* ``k1_no_arith``: K1 with each pair's coverage arithmetic replaced by a
  constant: the gather, the walk over the faces' boxes and the shared
  accumulators remain;
* ``k1_gather_only``: K1 without the walk: the gather and the barriers;
* ``k2``: K2 as shipped;
* ``k2_no_arith``: K2 with each pair's gradient arithmetic replaced by one
  add of g(1 − S): the walk over the faces' boxes and its loads remain.

The variants' outputs are wrong by design; only their times mean
anything. Each is timed twice, in alternating order. Prints one JSON line
per variant, then the card's ``nvidia-smi`` name and power limit. The
builds go under ``soccerplayershapepose_torch/_build/probe-*``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REPS = 20
# Text replacements that cut work out of the source; each must apply once.
CUTS = {
    "k1_no_arith": [("log_miss(fa, (float)px, (float)py, inv_sigma)",
                     "fa.x[0]")],
    "k1_gather_only": [("for (int s = warp; s < n_hit; s += kFwdWarps)",
                        "for (int s = warp; s < 0; s += kFwdWarps)")],
    "k2_no_arith": [("add_pair_grad(fa, (float)ix, py, __ldg(row + ix), "
                     "inv_sigma, acc);",
                     "acc[0] += __ldg(row + ix);")],
}


def build_variants(src: str) -> dict:
    """{name: loaded library} for the shipped source and each cut, built by
    parallel nvcc calls."""
    from soccerplayershapepose_torch import _build
    nvcc = _build.find_nvcc()
    sources = {"shipped": src}
    for name, reps in CUTS.items():
        text = src
        for old, new in reps:
            if text.count(old) != 1:
                raise RuntimeError("%s: %r does not occur once" % (name, old))
            text = text.replace(old, new)
        sources[name] = text
    procs = {}
    for name, text in sources.items():
        out_dir = os.path.join(_build.BUILD_ROOT, "probe-" + name)
        os.makedirs(out_dir, exist_ok=True)
        cu = os.path.join(out_dir, "band_raster.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, "libprobe.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", lib, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)[0]
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, out[-3000:]))
        handle = ctypes.CDLL(lib)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        handle.spt_band_raster_fwd.argtypes = [p] * 9 + [i] * 6 + [f, f, p]
        handle.spt_band_raster_fwd.restype = i
        handle.spt_band_raster_bwd.argtypes = [p] * 4 + [i] * 3 + [f, p]
        handle.spt_band_raster_bwd.restype = i
        libs[name] = handle
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_band_kernels: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from soccerplayershapepose_torch import config as cfg
    from soccerplayershapepose_torch.ops import (
        batch_rodrigues, perspective_project, weak_perspective_to_translation)
    from soccerplayershapepose_torch.render import band_raster as br
    from soccerplayershapepose_torch.smpl import synthesize_assets, smpl_forward

    dev = torch.device("cuda")
    with open(os.path.join(ROOT, "soccerplayershapepose_torch", "csrc",
                           "band_raster.cu")) as f:
        libs = build_variants(f.read())

    b, wh = cs.FIT_BATCH, cs.FIT_RENDER_WH
    assets = synthesize_assets(device=dev)
    aa, betas, cam, _, _ = cs.bench_scene(b)
    rot = batch_rodrigues(torch.from_numpy(aa).to(dev))
    with torch.no_grad():
        out = smpl_forward(assets, torch.from_numpy(betas).to(dev),
                           rot[:, 1:], rot[:, :1])
        tr = weak_perspective_to_translation(torch.from_numpy(cam).to(dev),
                                             cfg.FOCAL_LENGTH, cs.PROXY_WH)
        v2d = perspective_project(out.vertices, None, tr,
                                  focal_length=cfg.FOCAL_LENGTH,
                                  img_wh=cs.PROXY_WH) * (wh / cs.PROXY_WH)
    sigma_px = cs.SIGMA * (wh / 2.0) ** 2
    margin = br.support_margin(sigma_px)
    args, _ = br.band_inputs(v2d, assets.faces, wh, sigma_px, True)
    fc, cymin = args[0], args[1]
    s = br.launch_fwd(*args, wh, sigma_px, margin)
    gs = ((torch.randn(s.shape, device=dev) * (1.0 - s))).contiguous()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    inv_sigma = br.inv_sigma_f32(sigma_px)
    out_s = torch.empty_like(s)
    out_d = torch.empty((b, fc.shape[1], 6), device=dev)

    def fwd(lib):
        return lambda: lib.spt_band_raster_fwd(
            *[br._ptr(t) for t in args], br._ptr(out_s), br._ptr(None), b,
            cymin.shape[1], br.CHUNK, wh, br.BAND_H, br.TILE_W, inv_sigma,
            float(margin), stream)

    def bwd(lib):
        return lambda: lib.spt_band_raster_bwd(
            br._ptr(fc), br._ptr(gs), br._ptr(out_d), br._ptr(None), b,
            fc.shape[1], wh, inv_sigma, stream)

    runs = {"k1": fwd(libs["shipped"]),
            "k1_no_arith": fwd(libs["k1_no_arith"]),
            "k1_gather_only": fwd(libs["k1_gather_only"]),
            "k2": bwd(libs["shipped"]),
            "k2_no_arith": bwd(libs["k2_no_arith"])}
    times = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            fn = runs[name]
            for _ in range(3):
                if fn() != 0:
                    raise RuntimeError("%s: launch failed" % name)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(REPS):
                fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / REPS)
    for name, ms in times.items():
        print(json.dumps({"variant": name, "b": b, "wh": wh,
                          "sigma": cs.SIGMA, "ms": ms}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
