"""The SSD backward's share of its roofline: the bound of one call at the
cell's shape (``yardstick/bounds_ssd.py``) over the mean device time
launched inside one ``ssd.backward`` span of the profiled stretch (the
backward op of one mixer). It reads the op's whole work, whatever kernels
and products implement it. None where the port records no such span."""

from bench_port.yardstick.bounds_ssd import cell_bounds


def read(r):
    calls = [h for h in r.trace.host if h["cat"] == "user_annotation" and h["name"] == "ssd.backward"]
    events = r.trace.in_span("ssd.backward")
    if not calls or not events:
        return None
    bound = cell_bounds(r.config, r.workload["micro_batch_size"])["bwd"]
    return 100.0 * bound / (sum(e["dur"] for e in events) * 1e-6 / len(calls))
