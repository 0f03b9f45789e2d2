"""A call's operations (the detector, ProxyNet on the top-K crops, the
regressor on their proxies, SMPL; counted from the layer shapes) over
(the traced window's mean call time × the float32 peak)."""

from benchmark import counts


def read(ctx):
    if "call_flops" not in ctx:
        return None
    call_s = sum(ctx["latencies"]) / len(ctx["latencies"])
    return 100.0 * ctx["call_flops"] / (call_s * counts.PEAK_FP32_FLOPS)
