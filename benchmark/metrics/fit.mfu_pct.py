"""A fit iteration's operations over (ms per iteration × the float32
peak): SMPL's forward and backward (the backward twice the forward) and
the silhouette's support pairs forward and backward."""

from benchmark import counts


def read(ctx):
    spans = (ctx.get("spans") or {}).get("fit")
    if not spans or "sil_pairs" not in ctx:
        return None
    ms = 1e3 * sum(spans) / (len(spans) * ctx["iters"])
    ops = ctx["smpl_flops"] + ctx["sil_pairs"] * (
        counts.SIL_FWD_OPS_PER_PAIR + counts.SIL_BWD_OPS_PER_PAIR)
    return 100.0 * ops / (ms * 1e-3 * counts.PEAK_FP32_FLOPS)
