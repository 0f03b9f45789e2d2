"""The share of the frame's slots that hold a player: 100 × the port's
counter ``frame.valid_slots`` (detector score ≥ the threshold) over
``frame.slots`` (the F × K slots that ProxyNet and the regressor compute),
over the profiled calls."""

from benchmark.metrics import _spans


def read(ctx):
    summ = _spans.summary()
    slots = (summ or {}).get("counters", {}).get("frame.slots")
    if not slots:
        return None
    return 100.0 * summ["counters"].get("frame.valid_slots", 0.0) / slots
