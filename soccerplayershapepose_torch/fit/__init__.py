"""Render-and-compare fitting: the engine and the single-view stage."""

from soccerplayershapepose_torch.fit.engine import (  # noqa: F401
    FitConfig, FitInit, FitResult, evaluate_fit, fit_metrics, run_fit_loop)
from soccerplayershapepose_torch.fit.single_view import (  # noqa: F401
    single_view_fit, splice_body_pose)
