"""Batched tensor math: rotations, cameras, segmentation metrics."""

from soccerplayershapepose_torch.ops.rotations import (  # noqa: F401
    batch_rodrigues, rot6d_to_rotmat)
from soccerplayershapepose_torch.ops.camera import (  # noqa: F401
    orthographic_project, perspective_project, undo_keypoint_normalisation,
    weak_perspective_to_translation)
from soccerplayershapepose_torch.ops.segmentation import (  # noqa: F401
    silhouette_confusion_metrics)
