"""Device time from ``torch.profiler``: busy, idle, kernels, host gaps.

The traced part of a ``--trace 1`` run runs under the profiler with CPU
and CUDA activities. From its events:

* ``busy_s``: the union of the intervals in which a device operation
  (kernel, copy, set) ran, so overlapping operations count once;
* ``window_s``: the traced part's wall time, synchronised at both ends;
* ``kernels``: total device milliseconds and launches by name;
* ``device_ops``: the ten names that took the most device time;
* ``idle_gaps``: the device's idle time between operations, by the
  innermost host operation that was running in the middle of each gap,
  the ten largest.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def _device_events(prof):
    out = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            tr = ev.time_range
            if tr.end > tr.start:
                out.append((tr.start, tr.end, ev.name))
    return out


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_at(host, times):
    """For each time (µs), the name of the shortest host event spanning
    it: one sweep over the events sorted by start."""
    host = sorted(host)
    names = ["host (no op)"] * len(times)
    active, i = [], 0
    for j in sorted(range(len(times)), key=times.__getitem__):
        t = times[j]
        while i < len(host) and host[i][0] <= t:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= t]
        if active:
            names[j] = min(active, key=lambda h: h[1] - h[0])[2]
    return names


def traced(fn: Callable[[], None]) -> dict:
    """Run ``fn`` under the profiler and read its device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    dev = _device_events(prof)
    if not dev:
        raise RuntimeError("the profiler saw no device operation")
    kernels = {}
    for s, e, name in dev:
        ms, n = kernels.get(name, (0.0, 0))
        kernels[name] = (ms + (e - s) / 1e3, n + 1)
    merged = _union([(s, e) for s, e, _ in dev])
    busy_us = sum(e - s for s, e in merged)
    host = [(ev.time_range.start, ev.time_range.end, ev.name)
            for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CPU]
    holes = [(e0, s1) for (_, e0), (s1, _) in zip(merged, merged[1:])
             if s1 > e0]
    gaps = {}
    for (e0, s1), name in zip(holes, _host_at(
            host, [(e0 + s1) / 2.0 for e0, s1 in holes])):
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0) / 1e6
    top_ops = sorted(((k, v[0] / 1e3) for k, v in kernels.items()),
                     key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_us / 1e6, "window_s": window,
            "kernels": kernels,
            "device_ops": [[k[:120], v] for k, v in top_ops],
            "idle_gaps": [[k[:120], v] for k, v in top_gaps]}


def kernel_ms(profile: dict, fragment: str):
    """(total ms, launches) of the kernels whose name holds ``fragment``;
    None when there is none."""
    hits = [v for k, v in profile["kernels"].items() if fragment in k]
    if not hits:
        return None
    return sum(h[0] for h in hits), sum(h[1] for h in hits)
