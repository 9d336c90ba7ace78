"""The micro-batches' device time in the kernels the yardstick's KINDS files
as "elementwise and other" (neither the port's kernels, GEMMs, reductions
nor copies), over all device time of the profiled micro-batches' forward
and backward. The update's kernels are left out: ``optimizer_ms`` reads
them, and the profiled stretch holds more updates a micro-batch than a
window does."""

from bench_port.yardstick.trace import OTHER


def read(r):
    events = r.trace.in_span("bench.accumulate")
    total = r.trace.device_s(events)
    return 100.0 * r.trace.by_kind(events).get(OTHER, 0.0) / total if total > 0 else None
