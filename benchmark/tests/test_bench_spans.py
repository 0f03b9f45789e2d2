"""The readers of the port's spans and counters: None without their data,
and their value on a hand-built ``profiling.summary()`` or context."""

import pytest

from benchmark import harness
from soccerplayershapepose_torch.utils import profiling

FIT = ("fit.smpl_host_ms", "fit.raster_host_ms", "fit.loop_self_ms")
FRAME = ("frame.decode_ms", "frame.valid_slot_pct")


def row(count, total_ms):
    return {"count": count, "total_ns": int(total_ms * 1e6), "self_ns": 0}


FIT_SUMMARY = {"spans": {
    "predict": row(1, 40.0),
    "predict/smpl.forward": row(1, 3.0),
    "fit.iter": row(4, 100.0),
    "fit.iter/fit.forward": row(4, 50.0),
    "fit.iter/fit.forward/smpl.forward": row(4, 12.0),
    "fit.iter/fit.forward/raster.fwd": row(4, 8.0),
    "fit.iter/fit.backward": row(4, 30.0),
    "fit.iter/fit.backward/raster.bwd": row(4, 6.0),
    "fit.iter/fit.select": row(4, 5.0)}, "counters": {}}

FRAME_SUMMARY = {"spans": {
    "frame": row(2, 300.0),
    "frame/frame.detect": row(2, 30.0),
    "frame/frame.detect/frame.decode": row(2, 9.0)},
    "counters": {"frame.slots": 44.0, "frame.valid_slots": 33.0}}


def with_summary(monkeypatch, summ):
    monkeypatch.setattr(profiling, "summary", lambda: summ)


@pytest.mark.parametrize("name", FIT + FRAME)
def test_span_readers_give_none_without_spans(monkeypatch, name):
    ctx = {"traced_calls": 2, "frames_per_call": 1}
    with_summary(monkeypatch, {"spans": {}, "counters": {}})
    assert harness.metric_reader(name)(ctx) is None
    monkeypatch.delattr(profiling, "summary")
    assert harness.metric_reader(name)(ctx) is None


def test_fit_readers_split_the_iteration(monkeypatch):
    with_summary(monkeypatch, FIT_SUMMARY)
    got = {n: harness.metric_reader(n)({}) for n in FIT}
    assert got["fit.smpl_host_ms"] == pytest.approx(3.0)
    assert got["fit.raster_host_ms"] == pytest.approx(3.5)
    assert got["fit.loop_self_ms"] == pytest.approx(18.5)
    assert sum(got.values()) == pytest.approx(25.0)


def test_frame_readers(monkeypatch):
    with_summary(monkeypatch, FRAME_SUMMARY)
    ctx = {"traced_calls": 2, "frames_per_call": 1}
    assert harness.metric_reader("frame.decode_ms")(ctx) == \
        pytest.approx(4.5)
    assert harness.metric_reader("frame.decode_ms")(
        {"traced_calls": 2, "frames_per_call": 3}) == pytest.approx(1.5)
    assert harness.metric_reader("frame.decode_ms")({}) is None
    assert harness.metric_reader("frame.valid_slot_pct")(ctx) == \
        pytest.approx(75.0)


def test_roi_align_reader_reads_the_stage_times():
    read = harness.metric_reader("frame.roi_align_ms")
    assert read({"spans": None, "units": 3}) is None
    assert read({"spans": {"detect": [0.01]}, "units": 3}) is None
    assert read({"spans": {"roi_align": [0.003, 0.006]}, "units": 3}) == \
        pytest.approx(3.0)
