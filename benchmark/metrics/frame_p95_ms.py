"""95th percentile of the window's call latencies (one frame a call),
from the hand-over of the host frame to its outputs on the card, in ms.
None with fewer than 200 calls: the tail needs ten samples beyond it."""

from benchmark.stats import percentile, samples_beyond


def read(ctx):
    lat = ctx["latencies"]
    if samples_beyond(len(lat), 95) < 10:
        return None
    return percentile(lat, 95) * 1e3
