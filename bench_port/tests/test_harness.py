"""CPU checks of a whole run of the harness at a tiny size: a sound run
comes out correct; the control (the reference computed from fp8 operands in
the program's place) and each fault a training cell can have, planted under
the timed path, come out not correct; the run refuses to start without a
card; the per-layer readers read a trace; and every name ``BENCHMARK.json``
gives has its file.

The tiny cell is pythia-14m (6 layers of 128) at 33 positions, 2 rows a
micro-batch, 2 micro-batches a compared update and 3 an update in the
window, with limits set from CPU readings
of this size (seeds 1-4): the program's loss_gap 4.3e-5 to 1.6e-4,
grad_gap 2.9e-3 to 1.1e-2, change_gap_median 1.0e-3 to 1.8e-3; the
control's loss_gap 8.2e-4 and 1.1e-3 (seeds 1, 2); half the batch
loss_gap 5.8e-3 and 1.1e-2, grad_gap 5.4e-2 and 0.15; an unchanged state
grad_gap and change_gap 1.
"""

import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from bench_port import harness
from bench_port.reference import train as reference
from bench_port.tests.tiny import pythia_cell
from bench_port.yardstick.trace import DeviceTrace

ROOT = Path(__file__).resolve().parents[2]
LIMITS = {"loss_gap": 4e-4, "grad_gap": 0.03, "change_gap_median": 0.01}


def _run(seed, fault=None):
    return harness.run(pythia_cell(limits=LIMITS), seed, 0.2, False, time.perf_counter(), device="cpu", fault=fault)


@pytest.mark.parametrize("seed", [1, 2**31 + 77])
def test_sound_run_is_correct(seed):
    out = _run(seed)
    assert out["correct"] is True, out["compared"]
    assert list(out)[-1] == "compared"
    assert out["attempted"] >= 1 and out["failed"] == 0  # the window runs at least one micro-batch
    assert set(out["metrics"]) == set()  # the tiny cell lists no end-to-end metric


@pytest.mark.parametrize("fault", harness.FAULTS)
def test_a_fault_under_the_timed_path_is_not_correct(fault):
    assert _run(3, fault=fault)["correct"] is False


@pytest.mark.parametrize("seed", [1, 2])
def test_control_is_not_correct(seed):
    cell = pythia_cell(limits=LIMITS)
    cfg, wl = cell.config, cell.workload
    ref = reference.train_steps(cfg, wl, seed, "cpu", cfg["reference_precision"], harness.COMPARED_STEPS)
    control = reference.train_steps(cfg, wl, seed, "cpu", cfg["control_precision"], harness.COMPARED_STEPS)
    ok, compared = harness.judge(harness.gaps(control, ref), LIMITS)
    assert not ok, compared


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "pythia-1b.noremat.mbs16", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout == ""


def _reading(workload, config, kernels, window):
    """A reading of a synthetic trace: ``kernels`` are (span, name, start,
    duration), each launched inside a host span of its own name on thread
    1; a backward's kernels are launched from thread 2, as autograd's
    engine launches them while the span's thread waits."""
    events = []
    for corr, (span, name, ts, dur) in enumerate(kernels, 1):
        events.append({"cat": "user_annotation", "name": span, "tid": 1, "ts": ts - 3, "dur": 2})
        events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 2 if "bwd" in name else 1,
                       "ts": ts - 2, "dur": 1, "args": {"correlation": corr}})
        events.append({"cat": "kernel", "name": name, "ts": ts, "dur": dur, "args": {"correlation": corr}})
    return harness.Reading(config, workload, window, 1.5, DeviceTrace.from_events(events))


def test_readers_on_a_trace():
    cell = harness.load_cell("pythia-1b.noremat.mbs16")
    acc = "bench.accumulate"
    window = {"seconds": 20.0, "updates": 1, "micro_batches": 36, "sequences": 576, "tokens": 576 * 2049}
    r = _reading(cell.workload, cell.config,
                 [(acc, "void flash_fwd_kernel<256>", 100, 2000.0), (acc, "void flash_fwd_kernel<256>", 3000, 2000.0),
                  (acc, "void flash_bwd_prep_kernel<bf16>", 6000, 100.0),
                  (acc, "void flash_bwd_kernel<256, true>", 6100, 9900.0),
                  (acc, "vectorized_elementwise_kernel", 20000, 1000.0),
                  ("bench.batch", "Memcpy HtoD (Pageable -> Device)", 25000, 100.0),
                  ("bench.optimizer", "multi_tensor_apply_kernel", 30000, 500.0)], window)
    read = {m["name"]: harness.load_metric(m["name"])(r) for m in cell.per_layer}
    from bench_port.yardstick.bounds import flash_bounds
    from bench_port.yardstick.flops import PEAK_BF16_FLOPS, flops_per_sequence

    fb = flash_bounds(16, 8, 2049, 256, True)
    assert read["flash_fwd_roofline"] == pytest.approx(100 * fb["fwd"] / 2e-3)
    assert read["flash_bwd_roofline"] == pytest.approx(100 * fb["bwd"] / 10e-3)
    assert read["optimizer_ms"] == pytest.approx(0.5)
    assert read["elementwise_share"] == pytest.approx(100 * 1000 / 15000)  # the optimizer's kernels left out
    # a micro-batch busy 15.1 ms / 4 traced, an update 0.5 ms, over the window's 36 and 1 in 20 s
    assert read["idle_share"] == pytest.approx(100 * (1 - (15.1e-3 / 4 * 36 + 0.5e-3) / 20.0))
    assert read["mfu"] == pytest.approx(100 * flops_per_sequence(cell.config) * 576 / 20.0 / PEAK_BF16_FLOPS)
    assert harness.load_metric("scan_fwd_roofline")(r) is None  # nothing to read: no value, never 0


def test_window_updates_where_the_accumulation_closes(monkeypatch):
    """The window opens just after the compared updates and updates after
    every ``accumulation`` micro-batches, over that many. The window's clock
    ticks a second a reading, so it holds 7 micro-batches."""
    cell = pythia_cell()
    prog = harness.Program(cell.config, cell.workload, 5, "cpu")
    divisors = []
    update = prog.update
    prog.update = lambda state, acc_steps: (divisors.append(acc_steps), update(state, acc_steps))
    prog.first_steps()
    assert divisors == [2.0, 2.0] and prog.index == 4
    ticks = itertools.count()
    monkeypatch.setattr(harness.time, "perf_counter", lambda: float(next(ticks)))
    window = harness.measure_window(prog, 6.5)
    assert window["micro_batches"] == 7 and window["updates"] == 2 and prog.pending == 1
    assert divisors[2:] == [3.0, 3.0] and prog.index == 4 + 7
    assert window["tokens"] == 7 * 2 * 33


def test_every_name_has_its_file():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert set(cell.workload["limits"]) <= {"loss_gap", "grad_gap", "change_gap", "change_gap_median"}
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "tokens_per_s"}
        assert cell.per_layer
    for m in bench["per_layer"]:
        assert (ROOT / "bench_port" / "metrics" / f"{m['name']}.py").is_file()
