"""The RMSNorm backward kernel's share of its roofline: the mean bytes bound
of a call at the cell's shape (micro-batch x sequence rows of d_model;
``yardstick/bounds_rmsnorm.py``) over the mean device time of an
``rmsnorm_bwd_kernel`` launch in the profiled stretch. A micro-batch runs
one backward for each block's norm, which also takes the residual stream's
gradient, and one for the final norm, which does not: the bound is the mean
of those calls' bounds."""

from bench_port.yardstick.bounds_rmsnorm import rmsnorm_bounds


def read(r):
    calls = r.trace.matching("rmsnorm_bwd_kernel")
    if not calls:
        return None
    c = r.config
    stream = "float32" if c["residual_in_fp32"] else c["compute_dtype"]
    rows, blocks = r.workload["micro_batch_size"] * c["sequence_length"], c["n_layer"]
    in_blocks, final = (rmsnorm_bounds(rows, c["d_model"], stream, c["compute_dtype"], res)["bwd"] for res in (True, False))
    bound = (blocks * in_blocks + final) / (blocks + 1)
    return 100.0 * bound / (sum(e["dur"] for e in calls) * 1e-6 / len(calls))
