"""The reader of the fit loop's replayed share, ``fit.graph_iter_pct``:
None without the port's counter or its spans, and its value on a
hand-built ``profiling.summary()``."""

import pytest

from benchmark import harness
from soccerplayershapepose_torch.utils import profiling

NAME = "fit.graph_iter_pct"


def row(count):
    return {"count": count, "total_ns": count * 1000, "self_ns": 0}


@pytest.mark.parametrize("summ", [
    None,
    {"spans": {}, "counters": {}},
    {"spans": {"fit.iter": row(100)}, "counters": {}},
    {"spans": {}, "counters": {"fit.graph_iters": 99.0}},
])
def test_reader_gives_none_without_its_data(monkeypatch, summ):
    monkeypatch.setattr(profiling, "summary", lambda: summ)
    assert harness.metric_reader(NAME)({}) is None


def test_reader_gives_none_without_the_recorder(monkeypatch):
    monkeypatch.delattr(profiling, "summary")
    assert harness.metric_reader(NAME)({}) is None


@pytest.mark.parametrize("replayed,iters,want", [
    (99.0, 100, 99.0), (0.0, 100, 0.0), (9.0, 10, 90.0)])
def test_reader_divides_replays_by_iterations(monkeypatch, replayed, iters,
                                              want):
    summ = {"spans": {"predict": row(1), "fit.iter": row(iters),
                      "fit.iter/fit.replay": row(int(replayed))},
            "counters": {"fit.graph_iters": replayed,
                         "fit.graph_captures": 0.0}}
    monkeypatch.setattr(profiling, "summary", lambda: summ)
    assert harness.metric_reader(NAME)({}) == pytest.approx(want)
