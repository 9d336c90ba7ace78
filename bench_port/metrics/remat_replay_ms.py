"""Device time of a micro-batch's remat replay, the blocks' recompute in the
backward: the kernels, copies and sets launched inside the port's
``remat.replay`` spans (``models/layers.py``, one a block), summed over the
profiled stretch and divided by its ``compared_accumulation``
micro-batches. None where no block is rematerialised."""


def read(r):
    events = r.trace.in_span("remat.replay")
    return sum(e["dur"] for e in events) * 1e-3 / r.workload["compared_accumulation"] if events else None
