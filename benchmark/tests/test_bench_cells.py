"""A cell added as files alone runs; the spec keeps to its contract."""

import json
import re
import shutil

from benchmark import harness
from benchmark.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_keeps_to_the_contract():
    spec = tiny.spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    metrics = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    for c in spec["configs"]:
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert (harness.REPO / c["file"]).is_file()
    for w in spec["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert (harness.BENCH / "workloads" / f"{w['traffic']}.json"
                ).is_file()
        assert len(w["why"]) <= 200
        cell = harness.Cell(spec, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").is_file()
    for m in spec["per_layer"]:
        assert m["moves"] in metrics
    assert len(json.dumps(spec)) < 64 * 1024


def test_a_new_cell_runs_from_new_files_alone(tmp_path):
    spec = tiny.spec()
    cell = tiny.fit_cell()
    (tmp_path / "benchmark/configs").mkdir(parents=True)
    (tmp_path / "benchmark/workloads").mkdir()
    (tmp_path / "benchmark/configs/svfit_32.json").write_text(
        json.dumps(cell.config))
    (tmp_path / "benchmark/workloads/views_b2.json").write_text(
        json.dumps(cell.traffic))
    spec["configs"].append({"name": "svfit_32", "source": "x",
                            "file": "benchmark/configs/svfit_32.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "fit32.b2", "config": "svfit_32",
                              "traffic": "views_b2", "chips": 1,
                              "why": "x"})
    for m in spec["end_to_end"]:
        if "fit512.b144" in m.get("workloads", []):
            m["workloads"].append("fit32.b2")
    new = harness.Cell(spec, "fit32.b2", root=tmp_path)
    res = harness.run_cell(new, tiny.SEED, 0.1, False, device="cpu")
    assert set(res["metrics"]) == {"fit_views_per_s", "setup_s"}
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] == 2
    shutil.rmtree(tmp_path / "benchmark")
