"""Cells of the benchmark cut to sizes the CPU runs in seconds."""

from __future__ import annotations

import copy

from benchmark import harness


def spec() -> dict:
    return harness.load_json(harness.REPO / "BENCHMARK.json")


def fit_cell(iters: int = 2, lr: float = None) -> harness.Cell:
    cell = harness.Cell(spec(), "fit512.b144")
    cell.config = copy.deepcopy(cell.config)
    cell.config["fit"].update(wh=32, iters=iters)
    if lr is not None:
        cell.config["fit"]["lr"] = lr
    cell.config["warm_iters"] = 1
    cell.config["check"]["rows"] = 2
    cell.traffic = {**cell.traffic, "pool": 4, "batch": 2,
                    "render_block": 4}
    return cell


def frame_cell() -> harness.Cell:
    cell = harness.Cell(spec(), "frame.f1")
    cell.config = copy.deepcopy(cell.config)
    cell.config["frame"].update(height=64, width=96, crop=64, top_k=4)
    cell.config["check"]["calls"] = 2
    cell.config["warm_calls"] = 1
    cell.traffic = {**cell.traffic, "pool": 2, "players": 3,
                    "cam_scale": [0.4, 0.6]}
    return cell


SEED = 2 ** 31 + 977
