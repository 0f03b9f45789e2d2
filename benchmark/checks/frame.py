"""The frame pipeline's answers against the plain reference.

A sample of the window's calls, drawn from the seed among the pool's
frames: for each, the answers of its last call in the window. The
reference recomputes the same frames from the same host arrays. Slots are
matched by box (each slot of one side to the slot of the other side with
the nearest box, both ways), so that two near-equal scores that swap
places are not counted as wrong answers. The numbers compared, the widest
over every slot of the sampled frames:

* ``box_px``: the matched boxes' gap (largest coordinate), pixels;
* ``score_gap``: the matched detector scores' gap;
* ``joints_px``: the matched keypoints' gap, crop pixels;
* ``verts_mm``: the matched vertices' gap, millimetres.

Each has its limit in the configuration's file.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import REPO
from benchmark.reference import frame as ref_frame
from benchmark.reference import nets, precision, smpl


def sample(seed: int, kept: dict, frames: int):
    rng = np.random.default_rng(seed)
    idx = sorted(kept)
    return sorted(rng.choice(idx, size=min(frames, len(idx)),
                             replace=False).tolist())


def reference(config: dict, frames: np.ndarray, per_call: int, device,
              tf32: bool = False) -> dict:
    """The reference's answers for frames (F, H, W, 3), ``per_call`` at a
    time as the program takes them, in the program's form; with ``tf32``
    in the control's precision."""
    fr = config["frame"]
    w = {k: nets.load_flat(str(REPO / p), device)
         for k, p in config["weights"].items()}
    model = smpl.load(device)
    out = []
    with (precision.tf32() if tf32 else precision.fp32()):
        for s in range(0, frames.shape[0], per_call):
            x = torch.as_tensor(frames[s:s + per_call], device=device)
            out.append(ref_frame.run(w["detector"], w["proxynet"],
                                     w["regressor"], model, x, fr["top_k"],
                                     fr["crop"], fr["border"]))
    r = ref_frame.FrameResult(*(torch.cat(v) for v in zip(*out)))
    return {"boxes": r.boxes, "scores": r.scores, "joints2d": r.joints2d,
            "vertices": r.vertices, "pose_rotmats": r.rotmats,
            "betas": r.betas, "cam_wp": r.cam_wp}


def _match(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(F, K) index of the slot of b whose box is nearest each box of a."""
    d = torch.abs(a[:, :, None, :] - b[:, None, :, :]).amax(-1)
    return d.argmin(-1)


@torch.no_grad()
def numbers(prog: dict, ref: dict, config: dict) -> dict:
    got = {"box_px": 0.0, "score_gap": 0.0, "joints_px": 0.0,
           "verts_mm": 0.0}
    for x, y in ((prog, ref), (ref, prog)):
        j = _match(x["boxes"], y["boxes"])

        def pick(t):
            return torch.gather(t, 1, j.reshape(j.shape + (1,) * (
                t.dim() - 2)).expand(j.shape + t.shape[2:]))

        gaps = {
            "box_px": torch.abs(x["boxes"] - pick(y["boxes"])).max(),
            "score_gap": torch.abs(x["scores"] - pick(y["scores"])).max(),
            "joints_px": torch.linalg.vector_norm(
                x["joints2d"] - pick(y["joints2d"]), dim=-1).max(),
            "verts_mm": 1e3 * torch.linalg.vector_norm(
                x["vertices"] - pick(y["vertices"]), dim=-1).max()}
        for k, v in gaps.items():
            got[k] = max(got[k], float(v))
    got["valid_share"] = float((prog["scores"] >= config["check"][
        "valid_score"]).float().mean())
    return got


def limited(got: dict, config: dict) -> dict:
    """The numbers that have a limit, each beside it."""
    limits = config["check"]["limits"]
    return {k: {"value": got[k], "limit": v} for k, v in limits.items()}


def gather(kept: dict, frames: np.ndarray, picks, per_call: int, device):
    prog = {k: torch.cat([kept[i][k] for i in picks]).to(device)
            for k in kept[picks[0]]}
    x = np.concatenate([frames[i * per_call:(i + 1) * per_call]
                        for i in picks])
    return prog, x


def run(config: dict, kept: dict, frames: np.ndarray, per_call: int,
        seed: int, device, control: bool = False) -> dict:
    """The numbers of the program's sampled answers; with ``control`` a
    second dict: those of the control (the reference in TF32 put in the
    program's place) on the same frames."""
    picks = sample(seed, kept, config["check"]["calls"])
    prog, x = gather(kept, frames, picks, per_call, device)
    ref = reference(config, x, per_call, device)
    got = numbers(prog, ref, config)
    if not control:
        return limited(got, config)
    return got, numbers(reference(config, x, per_call, device, tf32=True),
                        ref, config)
