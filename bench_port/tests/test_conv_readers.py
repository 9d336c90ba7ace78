"""CPU checks of the mamba cell's conv readers: ``conv_fwd_roofline`` and
``conv_bwd_roofline`` against the bytes of ``yardstick/bounds_conv.py`` on a
hand-made chrome trace, neither counting PyTorch's depthwise conv, and each
giving None where the program launches neither conv kernel.

    python -m pytest bench_port/tests/test_conv_readers.py -q
"""

import json
from pathlib import Path

import pytest

from bench_port import harness
from bench_port.yardstick.bounds_conv import conv_bytes
from bench_port.yardstick.bounds_rmsnorm import PEAK_BYTES
from bench_port.yardstick.trace import DeviceTrace

CONFIG = json.loads((Path(__file__).resolve().parent.parent / "configs" / "mamba-2.8b.json").read_text())
WORKLOAD = {"micro_batch_size": 8, "compared_accumulation": 1}
MAIN, AUTOGRAD = 1, 2


def _reading(launches) -> harness.Reading:
    """``launches``: (tid, ts, kernel, dur)."""
    events = []
    for corr, (tid, ts, name, dur) in enumerate(launches):
        events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid, "ts": ts, "dur": 2.0,
                       "args": {"correlation": corr}})
        events.append({"cat": "kernel", "name": name, "ts": 9000.0 + 500 * corr, "dur": dur,
                       "args": {"correlation": corr}})
    window = {"seconds": 10.0, "updates": 0, "micro_batches": 2, "sequences": 16, "tokens": 16 * 4096}
    return harness.Reading(CONFIG, WORKLOAD, window, 1.0, DeviceTrace.from_events(events))


def test_conv_rooflines_hold_each_call_to_its_bytes():
    """Each share: its bound at 8 x 4096 rows of 5120, width 4, bf16
    activations and (``bf16_sr``) bf16 taps and bias, over the mean call of
    its kernel; a PyTorch depthwise conv in the same trace counts for
    neither."""
    rows, ch, k = 8 * 4096, 5120, 4
    b = conv_bytes(rows, ch, k, "bfloat16", "bfloat16")
    assert b["fwd"] == rows * ch * 2 * 2 + (k + 1) * ch * 2
    assert b["bwd"] == rows * ch * 2 * 3 + (k + 1) * ch * 2 + (k + 1) * ch * 4
    launches = [(MAIN, 10.0 * i, "void causal_conv_fwd_kernel<__nv_bfloat16, __nv_bfloat16, 4, true>(...)", d)
                for i, d in enumerate((240.0, 260.0))]
    launches += [(AUTOGRAD, 100.0 + i, "void causal_conv_bwd_kernel<__nv_bfloat16, __nv_bfloat16, 4, true>(...)",
                  400.0) for i in range(3)]
    launches.append((MAIN, 50.0, "void at::native::(anonymous namespace)::conv_depthwise2d_forward_kernel<float>", 1750.0))
    r = _reading(launches)
    assert harness.load_metric("conv_fwd_roofline")(r) == pytest.approx(100 * b["fwd"] / PEAK_BYTES / 250e-6)
    assert harness.load_metric("conv_bwd_roofline")(r) == pytest.approx(100 * b["bwd"] / PEAK_BYTES / 400e-6)


def test_conv_readers_give_none_without_the_kernels():
    """The parent's program, its conv on PyTorch's depthwise kernels: both
    readers return None, never 0."""
    r = _reading([(MAIN, 10.0, "void at::native::(anonymous namespace)::conv_depthwise2d_forward_kernel<float>",
                   1750.0), (AUTOGRAD, 20.0, "conv_depthwise2d_grad_weight_kernel", 900.0)])
    assert [harness.load_metric(n)(r) for n in ("conv_fwd_roofline", "conv_bwd_roofline")] == [None, None]
