"""The RMSNorm calls of a micro-batch of a hybrid of Mamba and attention
layers (the port's ``models/jamba.py``), from the configuration's layer
counts, and the mean bytes bound of a call of each kernel over that mix
(``bounds_rmsnorm.py`` a call). Each layer has two norms over d_model, its
input's and its MLP's, whose backward also takes the residual add's
gradient; each Mamba mixer three inner norms, over dt_rank, d_state and
d_state channels, whose backward does not; one final norm, whose backward
does not. Under remat a layer's replay runs its norms' forwards again."""

from bench_port.yardstick.bounds_rmsnorm import rmsnorm_bounds
from bench_port.yardstick.flops_jamba import layer_counts


def hybrid_norm_calls(cfg: dict, wl: dict) -> dict:
    """Each kernel's calls a micro-batch, as (count, columns, stream dtype,
    takes the residual's gradient)."""
    n_attn, n_mamba = layer_counts(cfg)
    stream = "float32" if cfg["residual_in_fp32"] else cfg["compute_dtype"]
    in_layers = [(2 * (n_attn + n_mamba), cfg["d_model"], stream, True),
                 (n_mamba, cfg["dt_rank"], cfg["compute_dtype"], False),
                 (2 * n_mamba, cfg["d_state"], cfg["compute_dtype"], False)]
    final = [(1, cfg["d_model"], stream, False)]
    runs = 2 if wl["remat"] is not None else 1
    return {"fwd": [(runs * n, *rest) for n, *rest in in_layers] + final, "bwd": in_layers + final}


def hybrid_norm_mean_bounds(cfg: dict, wl: dict) -> dict:
    """Seconds a call of each kernel takes at least, on the mean over the
    micro-batch's calls."""
    rows = wl["micro_batch_size"] * cfg["sequence_length"]
    out = {}
    for kind, calls in hybrid_norm_calls(cfg, wl).items():
        total = sum(n * rmsnorm_bounds(rows, cols, stream, cfg["compute_dtype"], res)[kind]
                    for n, cols, stream, res in calls)
        out[kind] = total / sum(n for n, *_ in calls)
    return out
