"""CPU checks of the readers of the port's spans: ``forward_ms``,
``backward_ms``, ``lm_loss_ms`` and ``remat_replay_ms`` on a hand-made
chrome trace, and the spans reaching the harness's profiled stretch of a
tiny cell.

    python -m pytest bench_port/tests/test_span_readers.py -q
"""

import collections

import pytest

from bench_port import harness
from bench_port.tests.tiny import pythia_cell
from bench_port.yardstick.trace import DeviceTrace

READERS = ("forward_ms", "backward_ms", "lm_loss_ms", "remat_replay_ms")
MAIN, AUTOGRAD = 1, 2


def _trace(remat: bool) -> DeviceTrace:
    """Two micro-batches as the port records them: ``step.forward`` and
    ``step.backward`` on the main thread, ``xent.forward`` inside the
    forward on it, ``xent.backward`` and (with ``remat``) ``remat.replay``
    inside the backward on autograd's thread, which launches the backward's
    kernels while the main thread waits; a set among them, and the copy of
    the harness's feed outside every span of the port."""
    spans, launches = [], []  # (name, tid, ts, dur); (tid, ts, name, cat, dur)
    for k in range(2):
        t = 1000.0 * k
        spans += [("bench.batch", MAIN, t, 40.0), ("step.forward", MAIN, t + 50, 300.0),
                  ("xent.forward", MAIN, t + 250, 90.0), ("step.backward", MAIN, t + 400, 500.0),
                  ("xent.backward", AUTOGRAD, t + 410, 100.0)]
        if remat:
            spans += [("remat.replay", AUTOGRAD, t + 600, 50.0), ("remat.replay", AUTOGRAD, t + 700, 50.0)]
        launches += [(MAIN, t + 10, "Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 3.0),
                     (MAIN, t + 60, "nvjet_fwd", "kernel", 10.0),
                     (MAIN, t + 260, "logsumexp_kernel", "kernel", 20.0),
                     (MAIN, t + 330, "Memset (Device)", "gpu_memset", 1.0),
                     (AUTOGRAD, t + 420, "logsumexp_bwd_kernel", "kernel", 40.0),
                     (AUTOGRAD, t + 610, "elementwise_replay", "kernel", 5.0),
                     (AUTOGRAD, t + 710, "nvjet_replay", "kernel", 7.0),
                     (AUTOGRAD, t + 800, "flash_bwd_kernel", "kernel", 100.0)]
    events = [{"cat": "user_annotation", "name": n, "tid": tid, "ts": ts, "dur": dur} for n, tid, ts, dur in spans]
    for corr, (tid, ts, name, cat, dur) in enumerate(launches):
        events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid, "ts": ts, "dur": 2.0,
                       "args": {"correlation": corr}})
        events.append({"cat": cat, "name": name, "ts": 5000.0 + 200 * corr, "dur": dur, "args": {"correlation": corr}})
    return DeviceTrace.from_events(events)


def _reading(tr: DeviceTrace, compared: int = 2) -> harness.Reading:
    window = {"seconds": 10.0, "updates": 1, "micro_batches": 8, "sequences": 16, "tokens": 16 * 33}
    return harness.Reading({}, {"compared_accumulation": compared}, window, 1.0, tr)


@pytest.mark.parametrize("remat", [False, True])
def test_readers_sum_their_spans_over_the_micro_batches(remat):
    """Each sums the device events launched in its spans on either thread
    (kernels, copies and sets alike) and divides by the stretch's
    ``compared_accumulation``; the feed's copy counts in none."""
    r = _reading(_trace(remat))
    read = {name: harness.load_metric(name)(r) for name in READERS}
    assert read["forward_ms"] == pytest.approx((10 + 20 + 1) * 1e-3)
    assert read["backward_ms"] == pytest.approx((40 + 5 + 7 + 100) * 1e-3)
    assert read["lm_loss_ms"] == pytest.approx((20 + 1 + 40) * 1e-3)
    assert read["remat_replay_ms"] == (pytest.approx((5 + 7) * 1e-3) if remat else None)
    assert harness.load_metric("backward_ms")(_reading(_trace(remat), compared=4)) == pytest.approx(
        read["backward_ms"] / 2)


def test_readers_give_none_without_the_ports_spans():
    """A program that records no span of its own (the harness's alone):
    every reader returns None, never 0."""
    events = [{"cat": "user_annotation", "name": "bench.accumulate", "tid": MAIN, "ts": 0.0, "dur": 100.0},
              {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": MAIN, "ts": 10.0, "dur": 2.0,
               "args": {"correlation": 1}},
              {"cat": "kernel", "name": "nvjet", "ts": 20.0, "dur": 50.0, "args": {"correlation": 1}}]
    r = _reading(DeviceTrace.from_events(events))
    assert {name: harness.load_metric(name)(r) for name in READERS} == dict.fromkeys(READERS)


@pytest.mark.parametrize("remat", [None, "dots"])
def test_the_ports_spans_reach_the_profiled_stretch(remat):
    """The harness's profiled stretch of a tiny pythia (6 layers) on the
    CPU holds each span of the port once a micro-batch, and one replay a
    block under remat; each lies inside ``bench.accumulate``."""
    cell = pythia_cell(remat=remat)
    prog = harness.Program(cell.config, cell.workload, 11, "cpu")
    prog.first_steps()
    tr, _ = harness.trace_stretch(prog)
    spans = [h for h in tr.host if h["cat"] == "user_annotation"]
    counts = collections.Counter(h["name"] for h in spans)
    n = cell.workload["compared_accumulation"]
    ports = ("step.forward", "step.backward", "xent.forward", "xent.backward")
    assert {k: counts[k] for k in ports} == dict.fromkeys(ports, n)
    assert counts["remat.replay"] == (0 if remat is None else 6 * n)
    acc = [(h["ts"], h["ts"] + h["dur"]) for h in spans if h["name"] == "bench.accumulate"]
    assert all(any(t0 <= h["ts"] <= t1 for t0, t1 in acc) for h in spans if h["name"] in (*ports, "remat.replay"))
