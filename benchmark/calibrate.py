"""Readings that the check's limits are set from, on the card.

For each seed, in one process: the cell's system is set up from the
seed, runs ``--calls`` calls of the cell's own size and load, and its
answers are compared with the plain reference, as a benchmark run's check
compares them (the lower readings); for the seeds of ``--control-seeds``
the control, the reference in TF32 put in the program's place, is
compared with it on the same sampled answers (the upper readings). Prints
one JSON line per seed. The benchmark's own runs do not run this.

    python3 benchmark/calibrate.py --workload fit512.b144 \
        --seeds 11,12,13 --control-seeds 11,12,13 --calls 1
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import harness  # noqa: E402


def readings(cell: harness.Cell, seed: int, calls: int, control: bool,
             device: str = "cuda") -> dict:
    system = importlib.import_module(
        f"benchmark.systems.{cell.config['system']}")
    t0 = time.time()
    sut = system.System(cell.config, cell.traffic, seed, device)
    sut.warm()
    for _ in range(calls):
        sut.call()
    got = sut.check(control=control)
    out = {"seed": seed, "seconds": time.time() - t0}
    if control:
        out["program"], out["control"] = got
    else:
        out["program"] = got
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--calls", type=int, default=1)
    args = ap.parse_args(argv)
    harness.set_cache_dirs(harness.REPO)
    cell = harness.Cell(harness.load_json(harness.REPO / "BENCHMARK.json"),
                        args.workload)
    harness.require_cards(cell.chips)
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for s in (int(x) for x in args.seeds.split(",")):
        r = readings(cell, s, args.calls, s in ctl)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
