"""Device time of a micro-batch's LM-head loss, forward and backward, the
backward's recompute of each chunk's logits included: the kernels, copies
and sets launched inside the port's ``xent.forward`` and ``xent.backward``
spans (``ops/xent.py``), summed over the profiled stretch and divided by
its ``compared_accumulation`` micro-batches."""


def read(r):
    events = r.trace.in_span("xent.forward", "xent.backward")
    return sum(e["dur"] for e in events) * 1e-3 / r.workload["compared_accumulation"] if events else None
