"""Model FLOPs utilisation of the untraced window: the closed-form FLOPs of
every sequence the window trained (no recompute counted) over the window's
wall time, as a share of the card's dense bf16 peak (989 TFLOP/s, H100
SXM at 700 W; the run prints the card's power limit beside it)."""

from bench_port.yardstick.flops import PEAK_BF16_FLOPS, flops_per_sequence


def read(r):
    return 100.0 * flops_per_sequence(r.config) * r.window["sequences"] / r.window["seconds"] / PEAK_BF16_FLOPS
