"""Batched tensor math: rotations, cameras, segmentation metrics."""

from soccerplayershapepose_torch.ops.rotations import (  # noqa: F401
    batch_rodrigues, rot6d_to_rotmat, rotate_translate_points,
    rotmat_to_axis_angle, rotmat_to_rot6d)
from soccerplayershapepose_torch.ops.camera import (  # noqa: F401
    check_joints2d_visibility, normalise_keypoints, orthographic_project,
    perspective_project, translation_to_weak_perspective,
    undo_keypoint_normalisation, weak_perspective_to_translation)
from soccerplayershapepose_torch.ops.segmentation import (  # noqa: F401
    densepose_to_6part_lsp, joints2d_l2_error, multiclass_to_binary,
    silhouette_confusion_metrics)
