"""The flash-attention backward's share of its roofline: the bound of one
call at the cell's attention shape over the mean device time of a call,
which is every kernel named ``flash_bwd`` (the prep launch and the fused
kernel, or the prep launch, dq and dk/dv kernels of the split backward)
over the number of prep launches, one a call."""

from bench_port.yardstick.bounds import flash_bounds


def read(r):
    preps = r.trace.matching("flash_bwd_prep_kernel")
    if not preps:
        return None
    c = r.config
    bound = flash_bounds(r.workload["micro_batch_size"], c["num_attention_heads"], c["sequence_length"],
                         c["hidden_size"] // c["num_attention_heads"], True)["bwd"]
    per_call = sum(e["dur"] for e in r.trace.matching("flash_bwd")) * 1e-6 / len(preps)
    return 100.0 * bound / per_call
