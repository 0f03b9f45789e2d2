"""One run of one benchmark cell.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` finds the cell in ``BENCHMARK.json``, its configuration's
file and its traffic mix's file (``benchmark/workloads/<traffic>.json``),
and the system under test named by the configuration
(``benchmark/systems/<system>.py``). Then:

1. without a CUDA card, or with fewer cards than the cell asks for, it
   exits with code 3 and prints no result;
2. set-up: the system loads the package under test, its weights and the
   traffic pool made from the seed, and warms every shape the cell uses;
   ``setup_s`` runs from the process's start to here;
3. the window: closed-loop calls, one after another, until ``--seconds``
   have passed; the call in flight completes and counts;
4. with ``--trace 1`` the window synchronises at stage boundaries (spans),
   then a further stretch of calls runs under ``torch.profiler``;
5. the metrics: each is read by ``benchmark/metrics/<name>.py``; a reader
   that finds nothing returns None and the metric is left out;
6. the check: the system's program state is dropped and the plain
   reference recomputes a sample of the window's answers drawn from the
   seed; every number compared is printed beside its limit on standard
   error, and under ``checks`` as the result line's last key;
7. if ``sys.modules`` holds JAX, flax or the JAX package, it exits with
   code 4 and prints no result;
8. the last line of standard output is the result's JSON object.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "soccerplayershapepose_tpu")
EXIT_NO_CARD = 3
EXIT_FORBIDDEN = 4


def process_start() -> float:
    """Wall-clock time at which this process started (from /proc), or now
    where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks
                              / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def set_cache_dirs(root: Path) -> None:
    """Kernel and build caches at fixed paths inside the checkout."""
    cache = root / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell of the spec with its configuration and traffic mix, their
    files found under ``root``."""

    def __init__(self, spec: dict, name: str, root: Path = REPO):
        hits = [w for w in spec["workloads"] if w["name"] == name]
        if not hits:
            raise SystemExit(f"no workload {name!r} in the benchmark spec")
        self.workload = hits[0]
        self.name = name
        self.chips = int(self.workload["chips"])
        conf = [c for c in spec["configs"]
                if c["name"] == self.workload["config"]][0]
        self.config = load_json(root / conf["file"])
        self.traffic = load_json(root / BENCH.name / "workloads"
                                 / f"{self.workload['traffic']}.json")
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", [name])]


def metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list, ctx: dict) -> dict:
    out = {}
    for m in entries:
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules
                   if k.split(".")[0] in FORBIDDEN})


def require_cards(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False",
              file=sys.stderr)
        raise SystemExit(EXIT_NO_CARD)
    if torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        raise SystemExit(EXIT_NO_CARD)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = None) -> dict:
    """Set up, measure, read and check one cell; returns the result."""
    import torch
    t_start = time.time() if t_start is None else t_start
    system = importlib.import_module(
        f"benchmark.systems.{cell.config['system']}")
    t_built = time.time()
    sut = system.System(cell.config, cell.traffic, seed, device)
    t_warm = time.time()
    sut.warm()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.time() - t_start
    phases = {"start": t_built - t_start, **sut.setup_phases,
              "warm": time.time() - t_warm}
    print("setup phases (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)

    sut.spans = {} if trace else None
    latencies, units = [], 0
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        units += sut.call()
        t1 = time.perf_counter()
        latencies.append(t1 - t)
        if t1 - t0 >= seconds:
            break
    window_s = t1 - t0
    memory_peak = (torch.cuda.max_memory_allocated()
                   if device == "cuda" else 0)

    ctx = {"setup_s": setup_s, "window_s": window_s, "units": units,
           "latencies": latencies, "spans": sut.spans}
    result_device = {"platform": "gpu" if device == "cuda" else device,
                     "kind": (torch.cuda.get_device_name(0)
                              if device == "cuda" else "cpu"),
                     "count": cell.chips,
                     "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if trace:
        from benchmark import profiling
        sut.spans = None
        counted = []
        prof = profiling.traced(lambda: counted.append(sut.traced_calls()))
        ctx["profile"] = prof
        ctx["traced_calls"] = counted[0]
        ctx.update(sut.work())
        result_device["busy_s"] = prof["busy_s"]
        result_device["window_s"] = prof["window_s"]
        breakdown = {"device_ops": prof["device_ops"],
                     "idle_gaps": prof["idle_gaps"]}
        metrics = read_metrics(cell.per_layer, ctx)
    else:
        metrics = read_metrics(cell.end_to_end, ctx)

    checks = sut.check()
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": units, "failed": 0, "metrics": metrics,
              "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    import argparse
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs(REPO)
    cell = Cell(load_json(REPO / "BENCHMARK.json"), args.workload)
    require_cards(cell.chips)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_start=t_start)
    found = forbidden_modules()
    if found:
        print("loaded in the measuring process: " + ", ".join(found),
              file=sys.stderr)
        return EXIT_FORBIDDEN
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
