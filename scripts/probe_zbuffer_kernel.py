#!/usr/bin/env python3
"""Where the time of the z-buffer kernel K3 goes, on one CUDA card.

    python3 scripts/probe_zbuffer_kernel.py

Builds ``soccerplayershapepose_torch/csrc/zbuffer.cu`` as it is and in
variants with parts of the work cut out, and times each at the two pass
shapes of ``chip_smoke.py``'s evaluation (16 crops of the seed-10,000,000
scene at 512², and at 128² with the vertices scaled by 0.25) with CUDA
events:

* ``k3``: K3 as shipped;
* ``no_atomic``: each covered pair stores its key instead of the shared
  ``atomicMin`` (a CAS loop on sm_90): the race makes the output wrong;
* ``no_division``: a product in place of the IEEE division 1 / area;
* ``no_inside_work``: no pair passes the inside test, so neither the
  division, the depth nor the atomic runs: the gather, the walk over the
  faces' boxes, the edge functions and the resolve remain;
* ``gather_only``: without the walk: the gather, its barriers and the
  resolve;

and three variants that undo one design choice each, computing the same
output as ``k3``:

* ``branching_inside_test``: the inside test with && and ||, one branch
  per comparison;
* ``tile_w_32``: tiles of 8 x 32 pixels, K1's, instead of 8 x 128;
* ``one_block_per_tile``: no cluster: one block walks a tile's faces.

The variants' outputs are wrong by design; only their times mean
anything. Each is timed twice, in alternating order. Prints one JSON line
per variant and shape, then the card's ``nvidia-smi`` name and power
limit. The builds go under
``soccerplayershapepose_torch/_build/probe-zbuffer-*``.
"""

from __future__ import annotations

import ctypes
import json
import os
import sys

from probe_band_kernels import (ROOT, build_variants, nvidia_smi_line,
                                time_alternating)

# Text replacements that cut work out of the source; each must apply once.
CUTS = {
    "no_atomic": [("atomicMin(&keys[(py - y0) * kTileW + (px - x0)], "
                   "zkey(z, id));",
                   "keys[(py - y0) * kTileW + (px - x0)] = zkey(z, id);")],
    "no_division": [("__fdiv_rn(1.0f, p.area)", "__fmul_rn(p.area, 0.5f)")],
    "no_inside_work": [("if (covers(p)) {",
                        "if (covers(p) && p.area == -12345.0f) {")],
    "gather_only": [("for (int s = warp; s < n_hit; s += kWarps)",
                     "for (int s = warp; s < 0; s += kWarps)")],
    "branching_inside_test": [
        ("const bool pos = (p.e0 >= 0.f) & (p.e1 >= 0.f) & (p.e2 >= 0.f);",
         "const bool pos = p.e0 >= 0.f && p.e1 >= 0.f && p.e2 >= 0.f;"),
        ("const bool neg = (p.e0 <= 0.f) & (p.e1 <= 0.f) & (p.e2 <= 0.f);",
         "const bool neg = p.e0 <= 0.f && p.e1 <= 0.f && p.e2 <= 0.f;"),
        ("return (pos | neg) & (fabsf(p.area) > 1e-9f);",
         "return (pos || neg) && fabsf(p.area) > 1e-9f;")],
    "tile_w_32": [("constexpr int kTileW = 128;",
                   "constexpr int kTileW = 32;")],
    "one_block_per_tile": [("  return split;", "  return 1;")],
}
# Tile width each variant's launcher expects (K3's own where not given).
TILE_W = {"tile_w_32": 32}


def declare_zbuffer(handle) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.spt_zbuffer_bary.argtypes = [p] * 7 + [i] * 6 + [p]
    handle.spt_zbuffer_bary.restype = i


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_zbuffer_kernel: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from soccerplayershapepose_torch.render import band_raster as br
    from soccerplayershapepose_torch.render import zbuffer as zb
    from soccerplayershapepose_torch.smpl import synthesize_assets
    from soccerplayershapepose_torch.train import synth

    dev = torch.device("cuda")
    with open(os.path.join(ROOT, "soccerplayershapepose_torch", "csrc",
                           "zbuffer.cu")) as f:
        libs = build_variants(f.read(), "zbuffer.cu", CUTS, declare_zbuffer)

    assets = synthesize_assets(device=dev)
    draws = synth.sample_crop_draws(
        torch.Generator().manual_seed(cs.EVAL_SEED), cs.EVAL_BATCH)
    scene = synth.crop_scene(assets, synth.draws_to(draws, dev), cs.EVAL_WH)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    runs = {}
    alive = []      # the launches hold raw pointers: keep the tensors
    for b, wh, scale in cs.K3_SHAPES:
        tri9, _, cymin, cymax, _, _, _ = zb._sorted_tri_z_and_ranges(
            (scene["verts2d"][:b] * scale).contiguous(),
            scene["verts_z"][:b].contiguous(), scene["faces"])
        lo, hi = br._band_chunk_bounds(cymin, cymax, -(-wh // br.BAND_H),
                                       br.BAND_H, zb.MARGIN)
        zr = zb.face_records(tri9)
        out = [torch.empty((b, wh, wh), dtype=dt, device=dev)
               for dt in (torch.int32, torch.float32, torch.float32)]
        tensors = (zr, lo, hi, *out)
        alive.append(tensors)
        ptrs = [br._ptr(t) for t in tensors]
        for name, lib in libs.items():
            runs[(name, wh)] = (lambda lib=lib, ptrs=ptrs, b=b, wh=wh,
                                n=cymin.shape[1],
                                tw=TILE_W.get(name, zb.TILE_W):
                                lib.spt_zbuffer_bary(
                *ptrs, br._ptr(None), b, n, br.CHUNK, wh, br.BAND_H, tw,
                stream))
    times = time_alternating(runs)
    for (name, wh), ms in times.items():
        print(json.dumps({"variant": "k3" if name == "shipped" else name,
                          "b": cs.EVAL_BATCH, "wh": wh, "ms": ms}),
              flush=True)
    print(nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
