"""The gate backward kernel's share of its roofline: the bytes bound of one
call at the cell's shape (micro-batch x sequence rows of d_inner in the
compute dtype; ``yardstick/bounds_gate.py``) over the mean device time of a
launch of the kernel named ``gate_silu_bwd_kernel`` in the profiled
stretch. None where no such kernel ran."""

from bench_port.yardstick.bounds_gate import gate_bounds


def read(r):
    launches = r.trace.matching("gate_silu_bwd_kernel")
    if not launches:
        return None
    c = r.config
    bound = gate_bounds(r.workload["micro_batch_size"] * c["sequence_length"], c["d_inner"], c["compute_dtype"])["bwd"]
    return 100.0 * bound / (sum(e["dur"] for e in launches) * 1e-6 / len(launches))
