"""The measuring path fails without a card; it never falls back to the
CPU."""

import pytest
import torch

from benchmark import harness

ARGS = ["--workload", "fit512.b144", "--seed", "5", "--seconds", "1",
        "--trace", "0"]


def test_no_card_exits_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        harness.main(ARGS)
    assert e.value.code == harness.EXIT_NO_CARD
    assert capsys.readouterr().out == ""


def test_too_few_cards_exit_without_a_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit) as e:
        harness.main(ARGS)
    assert e.value.code == harness.EXIT_NO_CARD
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.Cell(harness.load_json(harness.REPO / "BENCHMARK.json"),
                        "frame.f1")
    res = harness.run_cell(cell, 7, 1.0, False)
    assert res["device"]["platform"] == "gpu"
    assert res["correct"]
