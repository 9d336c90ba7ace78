"""Device time of a micro-batch's SSD (Mamba-2's chunked scan), forward and
backward: the kernels, products, copies and sets launched inside the port's
``ssd.forward`` spans (``ops/ssd.py``: each mixer's scan, its replay under
remat included) and ``ssd.backward`` spans (the backward op), summed over
the profiled stretch and divided by its ``compared_accumulation``
micro-batches (``yardstick/layer_time.py``'s convention). None where the
port records no such span."""


def read(r):
    events = r.trace.in_span("ssd.forward", "ssd.backward")
    return sum(e["dur"] for e in events) * 1e-3 / r.workload["compared_accumulation"] if events else None
