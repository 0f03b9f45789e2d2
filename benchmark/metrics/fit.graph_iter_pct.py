"""The share of the profiled batch's fit iterations that replayed the fit
loop's CUDA graph: 100 × the port's counter ``fit.graph_iters`` over its
``fit.iter`` spans. None without the counter (a port whose loop has no
graph)."""

from benchmark.metrics import _spans


def read(ctx):
    summ = _spans.summary()
    replayed = (summ or {}).get("counters", {}).get("fit.graph_iters")
    if replayed is None:
        return None
    n = _spans.count(summ, ("fit.iter",))
    return 100.0 * replayed / n if n else None
