"""The selective-scan forward's share of its roofline: the bound of one
call at the cell's scan shape (micro-batch, sequence, d_inner, d_state, bf16
operands) over the mean device time of a ``scan_fwd_kernel`` launch in the
profiled stretch."""

from bench_port.yardstick.bounds import scan_bounds


def read(r):
    calls = r.trace.matching("scan_fwd_kernel")
    if not calls:
        return None
    c = r.config
    bound = scan_bounds(r.workload["micro_batch_size"], c["sequence_length"], c["d_inner"], c["d_state"])["fwd"]
    return 100.0 * bound / (sum(e["dur"] for e in calls) * 1e-6 / len(calls))
