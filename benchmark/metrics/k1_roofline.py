"""K1 (the forward soft-silhouette kernel ``band_fwd_kernel``) as a share
of its roofline, per launch."""

from benchmark import counts
from benchmark.metrics._silhouette import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "band_fwd", counts.SIL_FWD_OPS_PER_PAIR,
                        "k1_bytes")
