"""CPU checks of the mamba cell's readers: ``scan_ms`` on a hand-made chrome
trace, ``rmsnorm_fwd_roofline`` and ``rmsnorm_bwd_roofline`` against the
bytes of ``yardstick/bounds_rmsnorm.py``, and each giving None where the
program records neither the spans nor the kernels.

    python -m pytest bench_port/tests/test_mamba_readers.py -q
"""

import json
from pathlib import Path

import pytest

from bench_port import harness
from bench_port.yardstick.bounds_rmsnorm import PEAK_BYTES, rmsnorm_bytes
from bench_port.yardstick.trace import DeviceTrace

CONFIG = json.loads((Path(__file__).resolve().parent.parent / "configs" / "mamba-2.8b.json").read_text())
WORKLOAD = {"micro_batch_size": 8, "compared_accumulation": 1}
READERS = ("scan_ms", "rmsnorm_fwd_roofline", "rmsnorm_bwd_roofline")
MAIN, AUTOGRAD = 1, 2


def _reading(spans, launches) -> harness.Reading:
    """``spans``: (name, tid, ts, dur); ``launches``: (tid, ts, kernel, dur)."""
    events = [{"cat": "user_annotation", "name": n, "tid": tid, "ts": ts, "dur": dur} for n, tid, ts, dur in spans]
    for corr, (tid, ts, name, dur) in enumerate(launches):
        events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid, "ts": ts, "dur": 2.0,
                       "args": {"correlation": corr}})
        events.append({"cat": "kernel", "name": name, "ts": 9000.0 + 500 * corr, "dur": dur,
                       "args": {"correlation": corr}})
    window = {"seconds": 10.0, "updates": 0, "micro_batches": 2, "sequences": 16, "tokens": 16 * 4096}
    return harness.Reading(CONFIG, WORKLOAD, window, 1.0, DeviceTrace.from_events(events))


def test_scan_ms_sums_the_scan_spans():
    """The scan's forward (in the forward and in a replay) and its backward
    (the kernel and its epilogue, on autograd's thread) count; a norm
    outside them does not."""
    spans = [("scan.forward", MAIN, 100.0, 50.0), ("scan.forward", AUTOGRAD, 400.0, 50.0),
             ("scan.backward", AUTOGRAD, 600.0, 80.0)]
    launches = [(MAIN, 110.0, "scan_fwd_kernel<bf16, true>", 300.0), (AUTOGRAD, 410.0, "scan_fwd_kernel", 300.0),
                (AUTOGRAD, 610.0, "scan_bwd_kernel", 1500.0), (AUTOGRAD, 650.0, "elementwise_mul", 40.0),
                (MAIN, 200.0, "rmsnorm_fwd_kernel<float, bf16, 4>", 160.0)]
    assert harness.load_metric("scan_ms")(_reading(spans, launches)) == pytest.approx((300 + 300 + 1500 + 40) * 1e-3)


def test_norm_rooflines_hold_each_call_to_its_bytes():
    """The forward's share: its bound at 8 x 4096 rows of 2560 (f32 in, bf16
    out) over the mean call; the backward's: the mean of 64 block calls that
    also read the residual's gradient and the final norm's that does not."""
    rows, cols = 8 * 4096, 2560
    fwd_s = rmsnorm_bytes(rows, cols, "float32", "bfloat16", True)["fwd"] / PEAK_BYTES
    bwd = [rmsnorm_bytes(rows, cols, "float32", "bfloat16", res)["bwd"] / PEAK_BYTES for res in (True, False)]
    assert fwd_s == pytest.approx((rows * cols * 6 + cols * 4 + rows * 4) / 3.35e12)
    assert bwd[0] - bwd[1] == pytest.approx(rows * cols * 4 / 3.35e12)
    launches = [(MAIN, 10.0 * i, "void rmsnorm_fwd_kernel<float, __nv_bfloat16, 4>(...)", d) for i, d in
                enumerate((160.0, 170.0))]
    launches += [(AUTOGRAD, 100.0 + i, "void rmsnorm_bwd_kernel<float, __nv_bfloat16, 4>(...)", 400.0)
                 for i in range(3)]
    r = _reading([], launches)
    assert harness.load_metric("rmsnorm_fwd_roofline")(r) == pytest.approx(100 * fwd_s / 165e-6)
    assert harness.load_metric("rmsnorm_bwd_roofline")(r) == pytest.approx(100 * (64 * bwd[0] + bwd[1]) / 65 / 400e-6)


def test_readers_give_none_without_the_ports_spans_or_kernels():
    """A program with neither the scan's spans nor the norm kernels (the
    port before them): every reader returns None, never 0."""
    r = _reading([("bench.accumulate", MAIN, 0.0, 1000.0)], [(MAIN, 10.0, "scan_fwd_kernel", 300.0)])
    assert {name: harness.load_metric(name)(r) for name in READERS} == dict.fromkeys(READERS)
