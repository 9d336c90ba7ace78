"""Device time of the profiled update's optimizer step: the kernels launched
inside the benchmark's ``bench.optimizer`` span around the session's
``optimizer_update_fn`` call (clip, Adam, stochastic rounding)."""


def read(r):
    events = r.trace.in_span("bench.optimizer")
    return sum(e["dur"] for e in events) * 1e-3 if events else None
