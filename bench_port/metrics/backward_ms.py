"""Device time of a micro-batch's backward, remat's replay and the LM-head
loss's backward included: the kernels, copies and sets launched inside the
port's ``step.backward`` span (``training/step.py``), on any thread (autograd
launches them from its own), summed over the profiled stretch and divided
by its ``compared_accumulation`` micro-batches."""


def read(r):
    events = r.trace.in_span("step.backward")
    return sum(e["dur"] for e in events) * 1e-3 / r.workload["compared_accumulation"] if events else None
