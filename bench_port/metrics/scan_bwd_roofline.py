"""The selective-scan backward's share of its roofline: the bound of one
call at the cell's scan shape over the mean device time of a
``scan_bwd_kernel`` launch in the profiled stretch."""

from bench_port.yardstick.bounds import scan_bounds


def read(r):
    calls = r.trace.matching("scan_bwd_kernel")
    if not calls:
        return None
    c = r.config
    bound = scan_bounds(r.workload["micro_batch_size"], c["sequence_length"], c["d_inner"], c["d_state"])["bwd"]
    return 100.0 * bound / (sum(e["dur"] for e in calls) * 1e-6 / len(calls))
