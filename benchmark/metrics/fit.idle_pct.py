"""The device's idle share while the window runs: 1 − (device-busy
seconds per call, from the profiled calls' trace) / (the window's mean
call time). The profiler slows the host's side of a call, so the traced
calls' own wall would overstate the idle share."""


def read(ctx):
    p = ctx.get("profile")
    if p is None:
        return None
    busy = p["busy_s"] / ctx["traced_calls"]
    call = sum(ctx["latencies"]) / len(ctx["latencies"])
    return 100.0 * (1.0 - busy / call)
