"""Rate and tail arithmetic over a window."""

import importlib

import pytest

from benchmark import harness, stats


def test_rate_counts_a_stall_in_the_window():
    # 99 calls of 0.1 s and one stall of 5 s: the rate is over all 14.9 s.
    lat = [0.1] * 99 + [5.0]
    assert stats.rate(len(lat), sum(lat)) == pytest.approx(100 / 14.9)
    assert stats.rate(len(lat), sum(lat)) < 100 / 9.9


def test_p95_is_the_nearest_rank_of_every_call():
    lat = [0.1] * 190 + [1.0] * 10
    assert stats.percentile(lat, 95) == 0.1
    lat = [0.1] * 189 + [1.0] * 11
    assert stats.percentile(lat, 95) == 1.0
    assert stats.percentile(list(range(1, 201)), 95) == 190
    assert stats.samples_beyond(200, 95) == 10


def test_p95_reader_needs_ten_samples_beyond_the_tail():
    read = harness.metric_reader("frame_p95_ms")
    assert read({"latencies": [0.1] * 199}) is None
    lat = [0.12] * 190 + [0.5] * 9 + [3.0]
    assert read({"latencies": lat}) == pytest.approx(120.0)


def test_rates_of_the_readers():
    ctx = {"units": 288, "window_s": 12.0, "setup_s": 7.5}
    assert harness.metric_reader("fit_views_per_s")(ctx) == 24.0
    assert harness.metric_reader("frames_per_s")(ctx) == 24.0
    assert harness.metric_reader("setup_s")(ctx) == 7.5


def test_span_readers_leave_out_what_they_cannot_read():
    for name in ("fit.ms_per_iter", "fit.init_ms", "frame.detect_ms"):
        assert harness.metric_reader(name)({"spans": None}) is None
    ctx = {"spans": {"fit": [6.0, 6.2]}, "iters": 100}
    assert harness.metric_reader("fit.ms_per_iter")(ctx) == \
        pytest.approx(61.0)
    assert importlib.import_module("benchmark.stats") is stats
