"""Tracing and profiling helpers.

Counterpart of ``soccerplayershapepose_tpu/utils/profiling.py``:

* :class:`StepTimer` accumulates wall time per named stage and prints a
  summary table;
* :func:`trace` runs ``torch.profiler`` over a block (the CPU, and the
  card's kernels where CUDA is available) and writes a Chrome/Perfetto
  trace, ``trace.json``, into a directory;
* :func:`annotate` names a span on that timeline
  (``torch.profiler.record_function``).

The timer reads the host's clock: a stage that launches work on the card
without waiting for it is charged only the launch, so time a device stage
with a ``torch.cuda.synchronize()`` inside it.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


class StepTimer:
    """Accumulates wall time per named stage; prints a summary table."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = [f"{'stage':<32}{'total_s':>10}{'count':>8}{'mean_ms':>10}"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            total = self.totals[name]
            count = self.counts[name]
            lines.append(f"{name:<32}{total:>10.3f}{count:>8}"
                         f"{1000 * total / count:>10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block and write ``<log_dir>/trace.json`` (Chrome trace
    format; Perfetto and ``chrome://tracing`` open it). Yields the
    profiler, whose ``key_averages()`` the caller may read."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named span on the profiler's timeline (host, and the card's work
    launched inside it)."""
    return torch.profiler.record_function(name)
