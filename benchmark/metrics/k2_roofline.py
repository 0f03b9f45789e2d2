"""K2 (the backward soft-silhouette kernel ``band_bwd_kernel``) as a
share of its roofline, per launch."""

from benchmark import counts
from benchmark.metrics._silhouette import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "band_bwd", counts.SIL_BWD_OPS_PER_PAIR,
                        "k2_bytes")
