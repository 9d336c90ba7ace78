"""Device time of a micro-batch's selective scan, forward and backward: the
kernels, copies and sets launched inside the port's ``scan.forward`` spans
(``ops/selective_scan.py``: each block's scan, its replay under remat
included) and ``scan.backward`` spans (``ops/selective_scan_fused.py``: the
backward kernel and its f32 epilogue), summed over the profiled stretch and
divided by its ``compared_accumulation`` micro-batches. None where the port
records no such span."""


def read(r):
    events = r.trace.in_span("scan.forward", "scan.backward")
    return sum(e["dur"] for e in events) * 1e-3 / r.workload["compared_accumulation"] if events else None
