"""Device time of a micro-batch's forward, the LM-head loss's forward
included: the kernels, copies and sets launched inside the port's
``step.forward`` span (``training/step.py``), summed over the profiled
stretch and divided by its ``compared_accumulation`` micro-batches."""


def read(r):
    events = r.trace.in_span("step.forward")
    return sum(e["dur"] for e in events) * 1e-3 / r.workload["compared_accumulation"] if events else None
