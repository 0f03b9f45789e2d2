"""Host milliseconds per fit iteration in ``raster.fwd`` and
``raster.bwd`` (the port's spans around ``SoftSilhouetteBand``'s forward,
K1's launch and its host glue, and backward, K2's launch, the un-sort and
the scatter) inside ``fit.iter``, over the profiled batch. Profiled, so
higher than in an unprofiled iteration (``_spans.py``)."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.per_fit_iter(
        lambda s: _spans.total_ms(s, _spans.RASTER, "fit.iter"))
