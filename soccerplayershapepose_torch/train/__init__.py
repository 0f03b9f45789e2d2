"""Synthetic crops and the held-out regressor evaluation."""
