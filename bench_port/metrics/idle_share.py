"""The device's idle share of the untraced window: 1 - (the device busy
time the window's work takes) / (the window's wall time). The profiled
stretch gives the busy time of a micro-batch (the union of the intervals of
the kernels, copies and sets launched in its feed and its forward and
backward) and of an update (those launched in the optimizer's span); the
window's work is its micro-batches and its updates. The profiler's own host
cost lengthens the profiled stretch, so its wall time is not the divisor."""


def read(r):
    micro = r.trace.in_span("bench.batch", "bench.accumulate")
    update = r.trace.in_span("bench.optimizer")
    if not micro or not update:
        return None
    busy = (r.trace.busy_s(micro) / r.workload["compared_accumulation"] * r.window["micro_batches"]
            + r.trace.busy_s(update) * r.window["updates"])
    return 100.0 * (1.0 - busy / r.window["seconds"])
