"""CPU checks of what granite-4.0-h-micro adds to the benchmark: the SSD
readers (``ssd_ms``, ``ssd_fwd_roofline``, ``ssd_bwd_roofline``) on a
hand-made chrome trace and without the spans, the SSD's bound at the cell's
shape, Granite's closed-form FLOPs against the port's count under
``FlopCounterMode``, and the spans reaching the harness's profiled stretch
of a tiny Granite cell.

    python -m pytest bench_port/tests/test_granite.py -q
"""

import collections
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port import harness
from bench_port.tests.test_span_readers import AUTOGRAD, MAIN
from bench_port.yardstick import bounds_ssd, flops, flops_granite
from bench_port.yardstick.trace import DeviceTrace

READERS = ("ssd_ms", "ssd_fwd_roofline", "ssd_bwd_roofline")
CONFIGS = harness.HERE / "configs"
TYPES = ("mamba", "mamba", "attention", "mamba")  # the published period of 10, attention at 5, cut to 4 at 2
TINY = dict(hidden_size=64, d_model=64, d_inner=64, shared_intermediate_size=128, intermediate_size=128,
            vocab_size=256, data_vocab_size=256, num_attention_heads=4, num_key_value_heads=2, mamba_n_heads=4,
            mamba_d_head=16, mamba_d_state=16, d_state=16, mamba_chunk_size=32, num_hidden_layers=4,
            layer_types=list(TYPES), sequence_length=64)
NARROW = dict(D_MODEL=64, LAYER_TYPES=TYPES, NUM_HEADS=4, NUM_KV_HEADS=2, HEAD_DIM=16, MAMBA_HEADS=4,
              MAMBA_HEAD_DIM=16, D_STATE=16, CHUNK=32, INTERMEDIATE=128, VOCAB=256)


def _cfg(**kw) -> dict:
    cfg = json.loads((CONFIGS / "granite-4.0-h-micro.json").read_text())
    cfg.update(kw)
    return cfg


def _trace(k: int = 1) -> DeviceTrace:
    """``k`` micro-batches of one mixer as the port records it under
    whole-layer remat: ``ssd.forward`` inside ``mamba.forward`` on the main
    thread, again inside the layer's replay on autograd's thread, then
    ``ssd.backward`` inside ``mamba.backward``."""
    spans, launches = [], []  # (name, tid, ts, dur); (tid, ts, name, dur)
    for j in range(k):
        t = 2000.0 * j
        spans += [("mamba.forward", MAIN, t + 100, 100.0), ("ssd.forward", MAIN, t + 120, 50.0),
                  ("remat.replay", AUTOGRAD, t + 500, 200.0), ("ssd.forward", AUTOGRAD, t + 520, 50.0),
                  ("mamba.backward", AUTOGRAD, t + 800, 300.0), ("ssd.backward", AUTOGRAD, t + 850, 100.0)]
        launches += [(MAIN, t + 110, "nvjet_in_proj", 20.0), (MAIN, t + 125, "nvjet_cb", 3.0),
                     (MAIN, t + 130, "ssd_fwd_kernel", 40.0), (AUTOGRAD, t + 525, "nvjet_cb", 3.0),
                     (AUTOGRAD, t + 530, "ssd_fwd_kernel", 40.0), (AUTOGRAD, t + 860, "nvjet_dstates", 30.0),
                     (AUTOGRAD, t + 900, "ssd_bwd_kernel", 90.0), (AUTOGRAD, t + 1000, "nvjet_out_proj", 50.0)]
    events = [{"cat": "user_annotation", "name": n, "tid": tid, "ts": ts, "dur": dur} for n, tid, ts, dur in spans]
    for corr, (tid, ts, name, dur) in enumerate(launches):
        events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid, "ts": ts, "dur": 2.0,
                       "args": {"correlation": corr}})
        events.append({"cat": "kernel", "name": name, "ts": 9000.0 + 200 * corr, "dur": dur,
                       "args": {"correlation": corr}})
    return DeviceTrace.from_events(events)


def _reading(tr: DeviceTrace, compared: int) -> harness.Reading:
    wl = {"micro_batch_size": 8, "compared_accumulation": compared}
    return harness.Reading(_cfg(), wl, {}, 1.0, tr)


@pytest.mark.parametrize("k", [1, 2])
def test_ssd_readers(k):
    """``ssd_ms`` sums the events launched in the ``ssd.*`` spans, the
    replay's forward included, over the stretch's micro-batches; each
    roofline is its call's bound over the mean device time launched in one
    span of its kind, a replay a call of its own."""
    r = _reading(_trace(k), k)
    got = {name: harness.load_metric(name)(r) for name in READERS}
    bound = bounds_ssd.cell_bounds(_cfg(), 8)
    assert got == {"ssd_ms": pytest.approx((2 * (3 + 40) + 30 + 90) * 1e-3),
                   "ssd_fwd_roofline": pytest.approx(100.0 * bound["fwd"] / 43e-6),
                   "ssd_bwd_roofline": pytest.approx(100.0 * bound["bwd"] / 120e-6)}


def test_ssd_readers_give_none_without_the_spans():
    """A program that records no ``ssd.*`` span (the parent of these readers,
    or a model without Mamba-2): None, never 0."""
    events = [{"cat": "user_annotation", "name": "mamba.forward", "tid": MAIN, "ts": 0.0, "dur": 100.0},
              {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": MAIN, "ts": 10.0, "dur": 2.0,
               "args": {"correlation": 1}},
              {"cat": "kernel", "name": "scan_fwd_kernel", "ts": 20.0, "dur": 50.0, "args": {"correlation": 1}}]
    r = _reading(DeviceTrace.from_events(events), 1)
    assert {name: harness.load_metric(name)(r) for name in READERS} == dict.fromkeys(READERS)


def test_ssd_bound_at_the_cells_shape():
    """[8, 16384, 64, 64], one group of N 128, chunks of 256, bf16: the
    forward moves x, y, B, C, dt, A and D (2.2481 GB: 0.6711 ms at 3.35 TB/s)
    against 0.421 TFLOP of products (0.426 ms); the backward those inputs
    and dy in, dx, ddt, dB, dC, dA and dD out (3.4225 GB: 1.0217 ms) against
    twice the products (0.851 ms). Both bounds are bytes."""
    b, L, H, P, N, Q = 8, 16384, 64, 64, 128, 256
    nbytes = bounds_ssd.ssd_bytes(b, L, H, P, 1, N)
    x, bc, dt = b * L * H * P * 2, 2 * b * L * N * 2, b * L * H * 4
    assert nbytes == {"fwd": 2 * x + bc + dt + 2 * H * 4, "bwd": 3 * x + 2 * bc + 2 * dt + 4 * H * 4}
    products = bounds_ssd.ssd_products(b, L, H, P, 1, N, Q)
    assert products["fwd"] == b * (L // Q) * (2 * Q * Q * N + H * (4 * Q * N * P + P * Q * (Q + 1)))
    assert products["fwd"] == pytest.approx(b * L * flops_granite.ssd_flops_per_token(_cfg()))
    bound = bounds_ssd.cell_bounds(_cfg(), 8)
    assert bound["fwd"] == pytest.approx(nbytes["fwd"] / 3.35e12) == pytest.approx(0.6711e-3, rel=1e-4)
    assert bound["bwd"] == pytest.approx(nbytes["bwd"] / 3.35e12) == pytest.approx(1.0217e-3, rel=1e-4)
    assert products["bwd"] / 989e12 < bound["bwd"] and products["fwd"] / 989e12 < bound["fwd"]


def test_closed_form_against_the_ports_count():
    """The closed form at the tiny size, against ``FlopCounterMode`` over the
    port's forward and backward (the plain versions; the SSD, conv and
    flash ops counted by the port's formulas): equal once the count's three
    other terms are added, the LM head's logits recomputed in the backward
    (2 d_model V (S - 1)), the head's shifted S - 1 positions against the
    form's S (6 d_model V (S - 1) - 6 d_model V S), and the diagonal's causal
    pairs in each attention layer (6 heads d S)."""
    from multimodal_llm_pretraining_tpu_torch.benchmarking import flops as tflops  # noqa: F401  (the ops' formulas)
    from multimodal_llm_pretraining_tpu_torch.models.granite import GraniteLM

    cfg = _cfg(**TINY)
    s, dm, v, heads = cfg["sequence_length"], cfg["hidden_size"], cfg["vocab_size"], cfg["num_attention_heads"]
    model = GraniteLM(64, TYPES, 4, 2, 16, 4, 16, 16, 1, 4, 32, 128, 256)
    model.reset_parameters(torch.Generator().manual_seed(0))
    ids = torch.randint(0, 256, (1, s), generator=torch.Generator().manual_seed(1))
    with FlopCounterMode(display=False) as counter:
        model(ids, labels=ids).backward()
    n_attn, n_mamba = flops_granite.layer_counts(cfg)
    assert (n_attn, n_mamba) == (1, 3)
    extra = 2 * dm * v * (s - 1) + 6 * dm * v * (s - 1) - 6 * dm * v * s + n_attn * 6 * heads * (dm // heads) * s
    assert counter.get_total_flops() == pytest.approx(flops.flops_per_sequence(cfg) + extra, rel=1e-12)


def test_published_closed_form():
    """20.298 GFLOP a token at the published configuration and 16,384
    positions: 36 Mamba-2 mixers (54.79 M forward a token each, the SSD 3.21
    M of it), 4 attention mixers (88.08 M), 40 MLPs (100.66 M) and the head
    (411.04 M), each three times."""
    cfg = _cfg()
    assert flops_granite.layer_counts(cfg) == (4, 36)
    assert flops_granite.ssd_flops_per_token(cfg) == 2 * 256 * 128 + 64 * (4 * 128 * 64 + 64 * 257)
    assert flops.flops_per_sequence(cfg) / cfg["sequence_length"] == pytest.approx(20.298080256e9, rel=1e-9)


def test_the_layer_spans_reach_the_profiled_stretch(monkeypatch):
    """The harness's profiled stretch of a tiny Granite cell on the CPU (the
    module's sizes narrowed, whole-layer remat): the SSD's forward span once
    a mixer and again in its replay, its backward span once a mixer, each
    inside the mixer's own spans and all inside ``bench.accumulate``."""
    from multimodal_llm_pretraining_tpu_torch.models import granite as tgranite

    for name, value in NARROW.items():
        monkeypatch.setattr(tgranite, name, value)
    cfg = _cfg(**TINY)
    wl = {"micro_batch_size": 2, "accumulation": 2, "compared_accumulation": 1, "remat": "block", "limits": {}}
    prog = harness.Program(cfg, wl, 2**33 + 7, "cpu")
    prog.first_steps()
    tr, _ = harness.trace_stretch(prog)
    spans = [h for h in tr.host if h["cat"] == "user_annotation"]
    counts = collections.Counter(h["name"] for h in spans)
    assert {n: counts[n] for n in ("ssd.forward", "mamba.forward", "attn.forward", "ssd.backward", "mamba.backward",
                                   "remat.replay")} == {
        "ssd.forward": 6, "mamba.forward": 6, "attn.forward": 2, "ssd.backward": 3, "mamba.backward": 3,
        "remat.replay": 4}
    acc = [(h["ts"], h["ts"] + h["dur"]) for h in spans if h["name"] == "bench.accumulate"]
    assert all(any(t0 <= h["ts"] <= t1 for t0, t1 in acc) for h in spans if h["name"].startswith("ssd."))
