"""SMPL body model: assets and the batched LBS forward."""

from soccerplayershapepose_torch.smpl.assets import (  # noqa: F401
    SMPLAssets, load_assets, synthesize_assets)
from soccerplayershapepose_torch.smpl.model import (  # noqa: F401
    SMPLOutput, smpl_forward, smpl_shape_only)
