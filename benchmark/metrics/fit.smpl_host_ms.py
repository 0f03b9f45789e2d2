"""Host milliseconds per fit iteration in ``smpl.forward`` (the port's
span around ``smpl/model.py:smpl_forward``) inside ``fit.iter``, over the
profiled batch; a host wait for the card inside SMPL counts. Profiled, so
higher than in an unprofiled iteration (``_spans.py``)."""

from benchmark.metrics import _spans


def read(ctx):
    return _spans.per_fit_iter(
        lambda s: _spans.total_ms(s, _spans.SMPL, "fit.iter"))
