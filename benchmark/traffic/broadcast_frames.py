"""Broadcast-frame traffic: random players over a procedural pitch.

A pool of ``pool`` frames of ``height`` × ``width``, each with
``players`` bodies placed by their own weak-perspective cameras in the
max(h, w) square centred on the frame (scale and shift ranges from the
mix's file), two teams in random kit colours (jersey, shorts, skin
below), Lambert-shaded from a random light, painted far to near over a
green pitch with mowing stripes, two white lines and pixel noise. The
frames are handed over as host numpy arrays (F, H, W, 3) in [0, 1], as a
decoder yields them; the window takes them one call at a time in order
and starts over.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import pairs
from benchmark.reference import smpl
from benchmark.traffic import bodies


def _pitch(gen, h: int, w: int, dev) -> torch.Tensor:
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    base = torch.tensor([0.16, 0.42, 0.20], device=dev) \
        + bodies.uniform(gen, (3,), -0.04, 0.04)
    period = float(bodies.uniform(gen, (1,), 25.0, 90.0))
    theta = float(bodies.uniform(gen, (1,), 0.0, math.pi))
    proj = xs * math.cos(theta) + ys * math.sin(theta)
    img = base * (1.0 + 0.05 * torch.sign(torch.sin(
        proj * 2 * math.pi / period)))[..., None]
    for _ in range(2):
        a = float(bodies.uniform(gen, (1,), 0.0, math.pi))
        c = float(bodies.uniform(gen, (1,), 0.0, 1.0)) * max(h, w)
        dist = torch.abs(xs * math.cos(a) + ys * math.sin(a) - c)
        m = (torch.exp(-(dist / 1.5) ** 2) * 0.85)[..., None]
        img = img * (1 - m) + 0.93 * m
    return img + bodies.normal(gen, (h, w, 3)) * 0.02


def _face_groups(model: smpl.Model) -> torch.Tensor:
    """(F,) 0 skin (head), 1 jersey, 2 shorts, 3 legs, by the template
    height of a face's first vertex."""
    y = model.v_template[model.faces[:, 0], 1]
    return torch.where(y > 0.5, 0, torch.where(
        y > -0.35, 1, torch.where(y > -0.6, 2, 3)))


def make(params: dict, seed: int, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n_frames, n = params["pool"], params["players"]
    h, w = params["height"], params["width"]
    wh = max(h, w)
    model = smpl.load(device)
    groups = _face_groups(model)
    f = model.faces.shape[0]
    frames = []
    with torch.no_grad():
        for _ in range(n_frames):
            body, orient, betas = bodies.random_bodies(gen, n)
            lo, hi = params["cam_scale"]
            cam = torch.stack([
                bodies.uniform(gen, (n,), lo, hi),
                bodies.uniform(gen, (n,), -params["shift_x"],
                               params["shift_x"]),
                bodies.uniform(gen, (n,), -params["shift_y"],
                               params["shift_y"])], -1)
            kits = bodies.uniform(gen, (2, 3, 3), 0.05, 1.0)  # team, part
            skin = bodies.uniform(gen, (n, 1), 0.45, 0.85) * torch.tensor(
                [1.0, 0.75, 0.6], device=device)
            light = torch.nn.functional.normalize(
                bodies.normal(gen, (3,)) + torch.tensor(
                    [0.0, -1.0, -1.0], device=device), dim=0)
            verts, _ = smpl.forward(model, betas, body, orient)
            transl = smpl.translation(cam, wh)
            v2d = smpl.project(verts, transl, wh) + torch.tensor(
                [(w - wh) / 2.0, (h - wh) / 2.0], device=device)
            tri3 = verts[:, model.faces]                   # (n, F, 3, 3)
            normal = torch.nn.functional.normalize(torch.linalg.cross(
                tri3[:, :, 1] - tri3[:, :, 0], tri3[:, :, 2] - tri3[:, :, 0],
                dim=-1), dim=-1)
            shade = 0.45 + 0.55 * torch.abs(normal @ light)   # (n, F)
            team = (torch.arange(n, device=device) % 2)
            colour = torch.where(
                (groups == 0)[None, :, None], skin[:, None, :],
                torch.where((groups == 3)[None, :, None], skin[:, None, :]
                            * 0.9, kits[team][:, groups.clamp(1, 2) - 1]))
            colour = colour * shade[..., None]
            tri = v2d[:, model.faces]
            row, face = torch.nonzero(
                pairs.front_faces(tri), as_tuple=True)
            k, px, py = bodies.covered_pairs(tri[row, face], w, h)
            near = torch.argsort(torch.argsort(-transl[:, 2]))  # 0 farthest
            key = near[row[k]] * (n * f) + row[k] * f + face[k]
            pix = py * w + px
            top = torch.full((h * w,), -1, dtype=torch.int64, device=device)
            top.scatter_reduce_(0, pix, key, reduce="amax")
            img = _pitch(gen, h, w, device).reshape(h * w, 3)
            hit = top >= 0
            g = top[hit] % (n * f)
            img[hit] = colour.reshape(n * f, 3)[g]
            frames.append(torch.clamp(img.reshape(h, w, 3), 0.0, 1.0))
    pool = torch.stack(frames).cpu().numpy().astype(np.float32)
    return {"frames": pool, "per_call": params["frames_per_call"]}
