"""The RMSNorm forward kernel's share of its roofline: the bytes bound of
one call at the cell's shape (micro-batch x sequence rows of d_model, the
residual stream's dtype in, the compute dtype out;
``yardstick/bounds_rmsnorm.py``) over the mean device time of an
``rmsnorm_fwd_kernel`` launch in the profiled stretch (every block's norm,
its replay under remat, and the final norm: one shape)."""

from bench_port.yardstick.bounds_rmsnorm import rmsnorm_bounds


def read(r):
    calls = r.trace.matching("rmsnorm_fwd_kernel")
    if not calls:
        return None
    c = r.config
    stream = "float32" if c["residual_in_fp32"] else c["compute_dtype"]
    bound = rmsnorm_bounds(r.workload["micro_batch_size"] * c["sequence_length"], c["d_model"], stream,
                           c["compute_dtype"], True)["fwd"]
    return 100.0 * bound / (sum(e["dur"] for e in calls) * 1e-6 / len(calls))
