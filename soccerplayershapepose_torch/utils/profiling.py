"""Spans and counters of the port's own host code, and the trace exporter.

Counterpart of ``soccerplayershapepose_tpu/utils/profiling.py``. One
recorder for the whole package:

* :func:`span` names a stretch of host code. Recording is off by default,
  and then ``span`` returns a shared no-op context after one check: no
  ``record_function``, no synchronise, no allocation, no clock read.
* Recording is on inside :func:`recording` and while a ``torch.profiler``
  session records. A span then keeps its name, its start and end on
  ``time.perf_counter_ns()`` and its parent, and enters a record function
  of its name, which puts it on the profiler's timeline beside the card's
  events as a host operation. It is the function-scope record function
  (``torch._C._profiler._RecordFunctionFast``), not
  ``torch.profiler.record_function``: the profiler copies a user-scope
  range onto the card's timeline as a ``gpu_user_annotation`` spanning
  the kernels launched inside it, which readers of the device timeline
  would count as device work.
* Each thread keeps its own stack of open spans. A span opened on a thread
  with none open (autograd runs a CUDA ``backward`` on its device thread)
  takes as parent the innermost span open on another thread, the one whose
  ``backward()`` call waits for it: ``raster.bwd`` lands under
  ``fit.backward``.
* :func:`count` adds to a named counter; a device tensor counts its sum,
  added on the device and read on the host only by ``summary()``.
* Closed spans and counters go to the innermost open :func:`recording`,
  whose :meth:`Recorder.summary` reads them. Outside every
  ``recording()`` they go to the process's recorder: :func:`summary`
  reads it, :func:`reset` clears it.
* :class:`Stages` times a function's stages for its ``stage_times`` dict:
  each stage is a span that, with the dict, times itself and waits for
  the card at its end.
* :func:`trace` profiles a block with recording on and writes the Chrome
  trace, spans included; :func:`format_summary` prints a summary.

A span's time is the host's: work it launches on the card and does not
wait for is charged only its launch.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Iterator, Optional

import torch

_OFF = contextlib.nullcontext()
_profiler_enabled = torch.autograd._profiler_enabled


class Recorder:
    """Closed spans, as ``(id, parent id, path, start ns, end ns)``, and
    counters by name."""

    def __init__(self):
        self.spans = []
        self.counters = {}
        self._lock = threading.Lock()

    def add(self, name: str, n) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def clear(self) -> None:
        self.spans.clear()
        self.counters.clear()

    def summary(self) -> dict:
        """``{"spans": {path: {"count", "total_ns", "self_ns"}},
        "counters": {name: float}}``. A path joins the names from the root
        with ``/``; self time is a span's duration less the union of its
        children's intervals."""
        children = {}
        for _, parent, _, start, end in self.spans:
            if parent is not None:
                children.setdefault(parent, []).append((start, end))
        spans = {}
        for sid, _, path, start, end in self.spans:
            row = spans.setdefault(path, {"count": 0, "total_ns": 0,
                                          "self_ns": 0})
            row["count"] += 1
            row["total_ns"] += end - start
            row["self_ns"] += end - start - _covered(
                children.get(sid, ()), start, end)
        return {"spans": spans,
                "counters": {k: float(v) for k, v in self.counters.items()}}


def _covered(intervals, lo: int, hi: int) -> int:
    """Length of the union of ``intervals`` inside [lo, hi]."""
    total, reach = 0, lo
    for start, end in sorted(intervals):
        start, end = max(start, reach), min(end, hi)
        if end > start:
            total += end - start
            reach = end
    return total


_PROCESS = Recorder()
_SCOPES = []        # open recording()s, innermost last
_STACKS = {}        # thread ident → its open spans, innermost last
_IDS = itertools.count()


def _on() -> bool:
    return bool(_SCOPES) or _profiler_enabled()


def _store() -> Recorder:
    return _SCOPES[-1] if _SCOPES else _PROCESS


def _caller_span() -> Optional["_Span"]:
    """The innermost span open on another thread: the latest started."""
    tops = [s[-1] for s in list(_STACKS.values()) if s]
    return max(tops, key=lambda s: s.start, default=None)


class _Span:
    __slots__ = ("name", "path", "id", "parent", "start", "end", "_rf",
                 "_store")

    def __init__(self, name: str, store: Optional[Recorder]):
        self.name, self._store = name, store

    def __enter__(self) -> "_Span":
        tid = threading.get_ident()
        stack = _STACKS.get(tid)
        if stack:
            self.parent = stack[-1]
        else:
            self.parent = _caller_span()
            stack = _STACKS[tid] = []
        self.path = (self.name if self.parent is None
                     else f"{self.parent.path}/{self.name}")
        self.id = next(_IDS)
        stack.append(self)
        self._rf = torch._C._profiler._RecordFunctionFast(self.name)
        self._rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter_ns()
        self._rf.__exit__(*exc)
        tid = threading.get_ident()
        stack = _STACKS[tid]
        stack.pop()
        if not stack:
            del _STACKS[tid]
        if self._store is not None:
            parent = None if self.parent is None else self.parent.id
            self._store.spans.append((self.id, parent, self.path,
                                      self.start, self.end))
        return False


def span(name: str):
    """A named span around a ``with`` block: recorded while recording is
    on, else a shared no-op context."""
    if not _on():
        return _OFF
    return _Span(name, _store())


def count(name: str, n) -> None:
    """Add ``n`` (a number, or a tensor's sum, kept on its device) to the
    counter ``name`` while recording is on."""
    if not _on():
        return
    if isinstance(n, torch.Tensor):
        n = n.detach().sum()
    _store().add(name, n)


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Recording on inside the block, into a fresh :class:`Recorder` that
    the block yields."""
    rec = Recorder()
    _SCOPES.append(rec)
    try:
        yield rec
    finally:
        _SCOPES.remove(rec)


def summary() -> dict:
    """:meth:`Recorder.summary` of what was recorded outside every
    ``recording()``: the spans and counters of the process's
    ``torch.profiler`` sessions."""
    return _PROCESS.summary()


def reset() -> None:
    """Forget what :func:`summary` reads."""
    _PROCESS.clear()


class Stages:
    """The stages of one function for its ``stage_times`` dict.

    ``stages(key)`` is the span ``prefix + key``. Given ``times`` (a dict),
    the span times itself whether or not recording is on (spans inside it
    follow the rule of :func:`span`, so a stage costs what it did before
    it had spans), waits at its end for the card's queued work (``device``
    of type ``cuda``), and adds its seconds to ``times[key]``;
    construction first waits for the work queued before it, charged to no
    stage. Without ``times`` it is :func:`span`, and nothing waits."""

    def __init__(self, times: Optional[dict], device=None, prefix: str = ""):
        self.times, self.prefix = times, prefix
        self.device = torch.device(device) if device is not None else None
        if times is not None:
            self._wait()

    def _wait(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, key: str):
        if self.times is None:
            return span(self.prefix + key)
        return self._timed(key)

    @contextlib.contextmanager
    def _timed(self, key: str) -> Iterator[None]:
        with _Span(self.prefix + key, _store() if _on() else None) as s:
            yield
            self._wait()
        self.times[key] = self.times.get(key, 0.0) + (s.end - s.start) / 1e9


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[Recorder]:
    """Profile the block (the CPU, and the card where CUDA is available)
    with recording on, and write ``<log_dir>/trace.json`` (Chrome trace
    format, the spans among its events; Perfetto and ``chrome://tracing``
    open it). Yields the block's :class:`Recorder`."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with recording() as rec, \
            torch.profiler.profile(activities=acts) as prof:
        yield rec
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def format_summary(summ: dict) -> str:
    """A table of :meth:`Recorder.summary`: each span path with its count,
    total and self milliseconds, then each counter."""
    lines = [f"{'span':<56}{'count':>8}{'total_ms':>12}{'self_ms':>12}"]
    for path, row in sorted(summ["spans"].items()):
        lines.append(f"{path:<56}{row['count']:>8}"
                     f"{row['total_ns'] / 1e6:>12.3f}"
                     f"{row['self_ns'] / 1e6:>12.3f}")
    for name, value in sorted(summ["counters"].items()):
        lines.append(f"{name:<56}{value:>8g}")
    return "\n".join(lines)
