"""CPU checks of the mamba cell's gate readers: ``gate_fwd_roofline`` and
``gate_bwd_roofline`` against the bytes of ``yardstick/bounds_gate.py`` on a
hand-made chrome trace, each over the mean of its own kernel's launches,
neither counting PyTorch's elementwise kernels, and each giving None where
the program launches neither gate kernel.

    python -m pytest bench_port/tests/test_gate_readers.py -q
"""

import json
from pathlib import Path

import pytest

from bench_port import harness
from bench_port.yardstick.bounds_gate import PEAK_BYTES, gate_bounds, gate_bytes
from bench_port.yardstick.trace import OTHER, kind_of

from bench_port.tests.test_conv_readers import AUTOGRAD, MAIN, _reading

CONFIG = json.loads((Path(__file__).resolve().parent.parent / "configs" / "mamba-2.8b.json").read_text())
FWD = "void (anonymous namespace)::gate_silu_fwd_kernel<__nv_bfloat16, true>(...)"
BWD = "void (anonymous namespace)::gate_silu_bwd_kernel<__nv_bfloat16, true>(...)"
SILU = "void at::native::vectorized_elementwise_kernel<4, at::native::silu_kernel(...)::{lambda(float)#1}>"


def test_gate_bounds_by_hand():
    """At 8 x 4096 rows of 5120 in bf16: the forward moves y, z and out
    (1,006,632,960 bytes, 0.3005 ms at 3.35 TB/s), the backward dout, y, z,
    dy and dz (1,677,721,600 bytes, 0.5008 ms)."""
    b = gate_bytes(8 * 4096, 5120, "bfloat16")
    assert b == {"fwd": 1_006_632_960, "bwd": 1_677_721_600}
    t = gate_bounds(8 * 4096, 5120, "bfloat16")
    assert t["fwd"] == pytest.approx(0.3005e-3, rel=1e-3) and t["bwd"] == pytest.approx(0.5008e-3, rel=1e-3)
    assert gate_bytes(10, 4, "float32") == {"fwd": 3 * 160, "bwd": 5 * 160}


def test_gate_rooflines_divide_by_the_mean_launch():
    """Each share: its bound at the cell's shape (the configuration's d_inner
    and compute dtype, the traffic's 8 rows of 4096) over the mean device
    time of its kernel's launches, on whichever thread they were launched; a
    PyTorch SiLU in the same trace counts for neither, and both kernels file
    as elementwise work."""
    launches = [(MAIN, 10.0 * i, FWD, d) for i, d in enumerate((340.0, 360.0, 350.0, 350.0))]
    launches += [(AUTOGRAD, 100.0 + i, BWD, d) for i, d in enumerate((600.0, 640.0))]
    launches.append((MAIN, 50.0, SILU, 2000.0))
    r = _reading(launches)
    bounds = gate_bounds(8 * 4096, CONFIG["d_inner"], CONFIG["compute_dtype"])
    assert harness.load_metric("gate_fwd_roofline")(r) == pytest.approx(100 * bounds["fwd"] / 350e-6)
    assert harness.load_metric("gate_bwd_roofline")(r) == pytest.approx(100 * bounds["bwd"] / 620e-6)
    assert bounds["fwd"] == 3 * 8 * 4096 * 5120 * 2 / PEAK_BYTES
    assert kind_of(FWD) == kind_of(BWD) == OTHER


def test_gate_readers_give_none_without_the_kernels():
    """The parent's program, its gate on PyTorch's SiLU and products: both
    readers return None, never 0."""
    r = _reading([(MAIN, 10.0, SILU, 2000.0), (AUTOGRAD, 20.0, "silu_backward_kernel", 900.0)])
    assert [harness.load_metric(n)(r) for n in ("gate_fwd_roofline", "gate_bwd_roofline")] == [None, None]
