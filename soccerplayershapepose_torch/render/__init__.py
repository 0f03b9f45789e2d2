"""Differentiable soft-silhouette rendering."""

from soccerplayershapepose_torch.render.softras import (  # noqa: F401
    cull_backfaces, hard_silhouette, render_silhouette, soft_silhouette)
