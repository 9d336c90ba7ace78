"""The flash-attention forward's share of its roofline: the bound of one
call at the cell's attention shape (micro-batch, heads, sequence, head dim,
causal, bf16) over the mean device time of a ``flash_fwd_kernel`` launch in
the profiled stretch."""

from bench_port.yardstick.bounds import flash_bounds


def read(r):
    calls = r.trace.matching("flash_fwd_kernel")
    if not calls:
        return None
    c = r.config
    bound = flash_bounds(r.workload["micro_batch_size"], c["num_attention_heads"], c["sequence_length"],
                         c["hidden_size"] // c["num_attention_heads"], True)["fwd"]
    return 100.0 * bound / (sum(e["dur"] for e in calls) * 1e-6 / len(calls))
