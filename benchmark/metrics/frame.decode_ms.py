"""Host milliseconds per frame in ``frame.decode`` (the port's span around
``decode_detections``: peak test, sort, the NMS loop; and the square
boxes), over the profiled calls. Profiled, so higher than in an
unprofiled call (``_spans.py``)."""

from benchmark.metrics import _spans


def read(ctx):
    summ = _spans.summary()
    frames = ctx.get("traced_calls", 0) * ctx.get("frames_per_call", 0)
    if not summ or not frames or not _spans.count(summ, ("frame.decode",)):
        return None
    return _spans.total_ms(summ, ("frame.decode",)) / frames
