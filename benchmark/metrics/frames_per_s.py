"""Frames completed per second over the window's whole time."""

from benchmark.stats import rate


def read(ctx):
    return rate(ctx["units"], ctx["window_s"])
