"""On-disk wire-protocol interop (reference data formats, SURVEY.md §2.11)."""

from soccerplayershapepose_torch.io.formats import (  # noqa: F401
    read_json_xml, write_json_xml, read_boxes, write_boxes, read_index,
    write_index, read_joints2d, write_joints2d, read_metrics, write_metrics,
    read_fit_npz, write_fit_npz, write_png, read_multiview_npz, write_multiview_npz,
    read_hmr_prediction, read_spin_prediction, PlayerTree, walk_player_tree,
    calc_metrics)
