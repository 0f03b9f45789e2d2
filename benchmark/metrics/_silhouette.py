"""Shared arithmetic of the rasterizer rooflines: the support pairs of
the traced batch's initial and best meshes (averaged) times the
operations per pair, and the bytes counted from the shapes, over the
profiler's time per launch."""

from benchmark import counts, profiling


def roofline_pct(ctx, kernel: str, ops_per_pair: int, bytes_key: str):
    got = profiling.kernel_ms(ctx["profile"], kernel)
    if got is None or "sil_pairs" not in ctx:
        return None
    ms, launches = got
    bound = counts.roofline_ms(ctx["sil_pairs"] * ops_per_pair,
                               ctx[bytes_key])
    return 100.0 * bound / (ms / launches)
