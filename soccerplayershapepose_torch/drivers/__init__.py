"""High-level pipeline stage drivers over the folder-tree dataplane."""

from soccerplayershapepose_torch.drivers.stages import (  # noqa: F401
    load_proxy_batch, predict_stage, single_view_optimization,
    multi_view_optimization, broad_view_optimization, calc_initial_metrics)
