"""The SSD forward's share of its roofline: the bound of one call at the
cell's shape (``yardstick/bounds_ssd.py``: micro-batch x sequence, the
configuration's Mamba-2 heads, group and state, bytes over 3.35 TB/s
against products over 989 TFLOP/s) over the mean device time launched
inside one ``ssd.forward`` span of the profiled stretch; a layer's replay
under remat is a call. It reads the op's whole work, whatever kernels and
products implement it. None where the port records no such span."""

from bench_port.yardstick.bounds_ssd import cell_bounds


def read(r):
    calls = [h for h in r.trace.host if h["cat"] == "user_annotation" and h["name"] == "ssd.forward"]
    events = r.trace.in_span("ssd.forward")
    if not calls or not events:
        return None
    bound = cell_bounds(r.config, r.workload["micro_batch_size"])["fwd"]
    return 100.0 * bound / (sum(e["dur"] for e in events) * 1e-6 / len(calls))
