"""The RMSNorm backward kernel's share of its roofline in a hybrid of Mamba
and attention layers: the mean bytes bound of a call over the micro-batch's
mix of calls (the layers' norms over d_model, the Mamba mixers' inner norms
over dt_rank and d_state, the final norm; ``yardstick/bounds_rmsnorm_hybrid.py``)
over the mean device time of an ``rmsnorm_bwd_kernel`` launch in the
profiled stretch. None where no such kernel ran."""

from bench_port.yardstick.bounds_rmsnorm_hybrid import hybrid_norm_mean_bounds


def read(r):
    launches = r.trace.matching("rmsnorm_bwd_kernel")
    if not launches:
        return None
    bound = hybrid_norm_mean_bounds(r.config, r.workload)["bwd"]
    return 100.0 * bound / (sum(e["dur"] for e in launches) * 1e-6 / len(launches))
