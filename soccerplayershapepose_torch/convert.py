"""Carry state from numpy into the port.

The JAX package's ``SMPLAssets`` turned into numpy
(``{k: np.asarray(v) for k, v in dataclasses.asdict(assets).items()}``) and
a fit's initial parameters become the port's tensors, so both packages can
compute on the same numbers. Nothing is written to disk.
"""

from __future__ import annotations

import numpy as np

from soccerplayershapepose_torch import config as cfg
from soccerplayershapepose_torch.fit.engine import FitInit
from soccerplayershapepose_torch.smpl.assets import SMPLAssets
from soccerplayershapepose_torch.utils.precision import as_f32


def assets_from_numpy(d: dict, device="cpu") -> SMPLAssets:
    """dict of numpy arrays keyed like ``SMPLAssets`` → the port's assets.
    A ``parents`` entry, if present, gives the kinematic tree."""
    parents = d.get("parents", cfg.SMPL_PARENTS)
    arrays = {k: np.asarray(v) for k, v in d.items() if k != "parents"}
    return SMPLAssets.from_numpy(arrays, parents=tuple(parents), device=device)


def fit_init_from_numpy(body_pose, global_orient, betas, cam_wp,
                        device="cpu") -> FitInit:
    """(B, 23, 3, 3), (B, 1, 3, 3), (B, 10), (B, 3) arrays → ``FitInit``."""
    return FitInit(*(as_f32(np.asarray(x), device)
                     for x in (body_pose, global_orient, betas, cam_wp)))
