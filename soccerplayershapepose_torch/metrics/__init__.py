"""Metric measures and epoch trackers."""

from soccerplayershapepose_torch.metrics.measures import (  # noqa: F401
    pve, pve_sc, pve_pa, mpjpe, mpjpe_sc, mpjpe_pa, pose_mse, shape_mse)
from soccerplayershapepose_torch.metrics.tracker import (  # noqa: F401
    MetricsTracker, EvalMetricsTracker)
