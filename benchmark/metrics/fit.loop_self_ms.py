"""Host milliseconds per fit iteration in ``fit.iter`` outside SMPL and
the raster's spans: the loss, autograd outside K2's glue, the best-iterate
choice and Adam. With ``fit.smpl_host_ms`` and ``fit.raster_host_ms`` it
makes up the mean ``fit.iter`` span of the profiled batch. Profiled, so
higher than in an unprofiled iteration (``_spans.py``)."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.per_fit_iter(
        lambda s: _spans.total_ms(s, ("fit.iter",))
        - _spans.total_ms(s, _spans.SMPL + _spans.RASTER, "fit.iter"))
