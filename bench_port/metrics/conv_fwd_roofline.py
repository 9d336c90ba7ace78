"""The causal-conv forward kernel's share of its roofline: the bytes bound of
one call at the cell's shape (micro-batch x sequence rows of d_inner, width
d_conv, the compute dtype for the activations, the parameters' dtype for the
taps and bias; ``yardstick/bounds_conv.py``) over the summed device time of
the kernels whose name holds ``causal_conv_fwd`` in the profiled stretch,
per ``causal_conv_fwd_kernel`` launch. None where no such kernel
ran."""

from bench_port.yardstick.bounds_conv import conv_bounds, param_dtype


def read(r):
    launches = r.trace.matching("causal_conv_fwd_kernel")
    if not launches:
        return None
    c = r.config
    bound = conv_bounds(r.workload["micro_batch_size"] * c["sequence_length"], c["d_inner"], c["d_conv"],
                        c["compute_dtype"], param_dtype(c["state_layout"]))["fwd"]
    return 100.0 * bound / (sum(e["dur"] for e in r.trace.matching("causal_conv_fwd")) * 1e-6 / len(launches))
