"""Render-and-compare fitting: the engine and the single-view, multi-view,
broadcast-view and track stages."""

from soccerplayershapepose_torch.fit.engine import (  # noqa: F401
    FitConfig, FitInit, FitResult, evaluate_fit, fit_metrics, run_fit_loop)
from soccerplayershapepose_torch.fit.single_view import (  # noqa: F401
    single_view_fit, splice_body_pose)
from soccerplayershapepose_torch.fit.multi_view import (  # noqa: F401
    MultiViewInit, MultiViewResult, multi_view_fit)
from soccerplayershapepose_torch.fit.broad_view import (  # noqa: F401
    broad_view_fit)
from soccerplayershapepose_torch.fit.track import (  # noqa: F401
    TrackInit, TrackResult, track_fit)
