"""CPU checks of what Jamba adds to the benchmark: the readers of the
port's layer spans (``attention_ms``, ``mamba_ms``, ``mlp_ms``) on a
hand-made chrome trace, Jamba's closed-form FLOPs against the port's count
under ``FlopCounterMode``, and the spans reaching the harness's profiled
stretch of a tiny Jamba cell.

    python -m pytest bench_port/tests/test_jamba.py -q
"""

import collections
import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port import harness
from bench_port.tests.test_span_readers import AUTOGRAD, MAIN
from bench_port.yardstick import flops, flops_jamba
from bench_port.yardstick.trace import DeviceTrace

READERS = ("attention_ms", "mamba_ms", "mlp_ms")
CONFIGS = harness.HERE / "configs"
TINY = dict(hidden_size=64, d_model=64, d_inner=128, intermediate_size=128, vocab_size=256, data_vocab_size=256,
            mamba_dt_rank=8, dt_rank=8, num_attention_heads=4, num_hidden_layers=4, attn_layer_period=4,
            attn_layer_offset=1, sequence_length=48)
NARROW = dict(D_MODEL=64, N_LAYER=4, D_INNER=128, DT_RANK=8, NUM_HEADS=4, HEAD_DIM=16, INTERMEDIATE=128, VOCAB=256,
              ATTN_LAYER_PERIOD=4, ATTN_LAYER_OFFSET=1)


def _trace(k: int = 1) -> DeviceTrace:
    """``k`` micro-batches of one Mamba, one MLP and one attention call as
    the port records them under whole-layer remat: the forward spans on the
    main thread; on autograd's thread the attention's backward span, which
    holds the layer's replay (the replayed attention forward and a norm's
    kernel outside every layer span) before its own kernel, then the MLP's
    and the mixer's backward spans."""
    spans, launches = [], []  # (name, tid, ts, dur); (tid, ts, name, dur)
    for j in range(k):
        t = 2000.0 * j
        spans += [("mamba.forward", MAIN, t + 100, 100.0), ("mlp.forward", MAIN, t + 210, 90.0),
                  ("attn.forward", MAIN, t + 310, 90.0), ("attn.backward", AUTOGRAD, t + 500, 200.0),
                  ("remat.replay", AUTOGRAD, t + 510, 90.0), ("attn.forward", AUTOGRAD, t + 515, 45.0),
                  ("mlp.backward", AUTOGRAD, t + 800, 100.0), ("mamba.backward", AUTOGRAD, t + 1000, 100.0)]
        launches += [(MAIN, t + 110, "scan_fwd_kernel", 10.0), (MAIN, t + 220, "nvjet_mlp", 20.0),
                     (MAIN, t + 320, "flash_fwd_kernel", 30.0), (AUTOGRAD, t + 520, "flash_fwd_kernel", 4.0),
                     (AUTOGRAD, t + 570, "rmsnorm_fwd_kernel", 5.0), (AUTOGRAD, t + 650, "flash_bwd_kernel", 60.0),
                     (AUTOGRAD, t + 850, "nvjet_mlp_bwd", 70.0), (AUTOGRAD, t + 1050, "scan_bwd_kernel", 80.0),
                     (MAIN, t + 1500, "xent_fwd_kernel", 9.0)]
    events = [{"cat": "user_annotation", "name": n, "tid": tid, "ts": ts, "dur": dur} for n, tid, ts, dur in spans]
    for corr, (tid, ts, name, dur) in enumerate(launches):
        events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid, "ts": ts, "dur": 2.0,
                       "args": {"correlation": corr}})
        events.append({"cat": "kernel", "name": name, "ts": 9000.0 + 200 * corr, "dur": dur,
                       "args": {"correlation": corr}})
    return DeviceTrace.from_events(events)


def _reading(tr: DeviceTrace, compared: int) -> harness.Reading:
    window = {"seconds": 10.0, "updates": 1, "micro_batches": 4, "sequences": 8, "tokens": 8 * 48}
    return harness.Reading({}, {"compared_accumulation": compared}, window, 1.0, tr)


@pytest.mark.parametrize("k", [1, 2])
def test_layer_readers_split_the_replay_by_forward_span(k):
    """Each reader sums the events launched in its layer's forward spans and
    in its backward spans, a replay's events only where a forward span holds
    them (the replayed attention forward counts, the replayed norm in the
    attention's backward span does not), over the stretch's micro-batches."""
    r = _reading(_trace(k), k)
    got = {name: harness.load_metric(name)(r) for name in READERS}
    assert got == {"attention_ms": pytest.approx((30 + 4 + 60) * 1e-3), "mamba_ms": pytest.approx((10 + 80) * 1e-3),
                   "mlp_ms": pytest.approx((20 + 70) * 1e-3)}


def test_layer_readers_give_none_without_the_spans():
    """A program that records none of the layer spans (the parent of this
    reader, or a model without such a layer): None, never 0."""
    events = [{"cat": "user_annotation", "name": "step.forward", "tid": MAIN, "ts": 0.0, "dur": 100.0},
              {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": MAIN, "ts": 10.0, "dur": 2.0,
               "args": {"correlation": 1}},
              {"cat": "kernel", "name": "nvjet", "ts": 20.0, "dur": 50.0, "args": {"correlation": 1}}]
    r = _reading(DeviceTrace.from_events(events), 1)
    assert {name: harness.load_metric(name)(r) for name in READERS} == dict.fromkeys(READERS)


def _tiny_cfg() -> dict:
    cfg = json.loads((CONFIGS / "jamba2-3b.json").read_text())
    cfg.update(TINY)
    return cfg


def test_closed_form_against_the_ports_count():
    """The closed form at the tiny size, against ``FlopCounterMode`` over the
    port's forward and backward (the kernels' plain versions, the conv,
    scan and flash ops counted by the port's formulas): equal once the
    count's three other terms are added, the LM head's logits recomputed
    in the backward (2 d_model V (S - 1)), the head's shifted S - 1
    positions against the form's S (6 d_model V (S - 1) - 6 d_model V S),
    and the diagonal's causal pairs in each attention layer (6 heads d S)."""
    from multimodal_llm_pretraining_tpu_torch.benchmarking import flops as tflops  # noqa: F401  (the ops' formulas)
    from multimodal_llm_pretraining_tpu_torch.models.jamba import JambaLM

    cfg = _tiny_cfg()
    s, dm, v, heads = cfg["sequence_length"], cfg["hidden_size"], cfg["vocab_size"], cfg["num_attention_heads"]
    model = JambaLM(64, 4, 128, 16, 4, 8, 4, 1, 16, 128, 256, 4, 1)
    model.reset_parameters(torch.Generator().manual_seed(0))
    ids = torch.randint(0, 256, (1, s), generator=torch.Generator().manual_seed(1))
    with FlopCounterMode(display=False) as counter:
        model(ids, labels=ids).backward()
    n_attn, _ = flops_jamba.layer_counts(cfg)
    extra = 2 * dm * v * (s - 1) + 6 * dm * v * (s - 1) - 6 * dm * v * s + n_attn * 6 * heads * (dm // heads) * s
    assert counter.get_total_flops() == pytest.approx(flops.flops_per_sequence(cfg) + extra, rel=1e-12)


def test_published_closed_form():
    """18.72 GFLOP a token at the published configuration and 16,384
    positions: the MLPs 3.52 G forward, the Mamba mixers 2.16 G, the head
    0.34 G, attention 0.22 G, each three times."""
    cfg = json.loads((CONFIGS / "jamba2-3b.json").read_text())
    assert flops_jamba.layer_counts(cfg) == (2, 26)
    assert flops.flops_per_sequence(cfg) / cfg["sequence_length"] == pytest.approx(18.72116736e9, rel=1e-9)


def test_the_layer_spans_reach_the_profiled_stretch(monkeypatch):
    """The harness's profiled stretch of a tiny Jamba cell on the CPU (the
    module's sizes narrowed, whole-layer remat): each layer span once a
    call, the forward ones again in each layer's replay, all inside
    ``bench.accumulate``."""
    from multimodal_llm_pretraining_tpu_torch.models import jamba as tjamba

    for name, value in NARROW.items():
        monkeypatch.setattr(tjamba, name, value)
    cfg = _tiny_cfg()
    wl = {"micro_batch_size": 2, "accumulation": 2, "compared_accumulation": 1, "remat": "block", "limits": {}}
    prog = harness.Program(cfg, wl, 2**33 + 5, "cpu")
    prog.first_steps()
    tr, _ = harness.trace_stretch(prog)
    spans = [h for h in tr.host if h["cat"] == "user_annotation"]
    counts = collections.Counter(h["name"] for h in spans)
    assert {n: counts[n] for n in ("attn.forward", "mamba.forward", "mlp.forward", "remat.replay")} == {
        "attn.forward": 2, "mamba.forward": 6, "mlp.forward": 8, "remat.replay": 4}
    assert {n: counts[n] for n in ("attn.backward", "mamba.backward", "mlp.backward")} == {
        "attn.backward": 1, "mamba.backward": 3, "mlp.backward": 4}
    acc = [(h["ts"], h["ts"] + h["dur"]) for h in spans if h["name"] == "bench.accumulate"]
    layer = ("attn.", "mamba.", "mlp.")
    assert all(any(t0 <= h["ts"] <= t1 for t0, t1 in acc) for h in spans if h["name"].startswith(layer))



def test_hybrid_norm_calls_count_the_ports_launches():
    """The mix the hybrid norm readers weigh their bound by: 269 forward and
    135 backward calls a micro-batch at the published configuration under
    whole-layer remat, and at two layers, one of each kind, the 15 and 8
    launches the card test ``test_jamba_micro_batch_runs_on_the_kernels``
    counts; without remat the forwards run once."""
    from bench_port.yardstick.bounds_rmsnorm_hybrid import hybrid_norm_calls

    cfg = json.loads((CONFIGS / "jamba2-3b.json").read_text())
    wl = json.loads((harness.HERE / "workloads" / "jamba2-3b.remat.mbs8.json").read_text())

    def counts(c, w):
        return {k: sum(n for n, *_ in v) for k, v in hybrid_norm_calls(c, w).items()}

    assert counts(cfg, wl) == {"fwd": 269, "bwd": 135}
    two = dict(cfg, num_hidden_layers=2, attn_layer_period=2, attn_layer_offset=1)
    assert counts(two, wl) == {"fwd": 15, "bwd": 8}
    assert counts(cfg, dict(wl, remat=None)) == {"fwd": 135, "bwd": 135}


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_hybrid_norm_readers(kind):
    """Each hybrid norm reader: the mean bound of a call over the mix, from
    ``bounds_rmsnorm.py`` call by call, over a launch's mean device time;
    None where no norm kernel ran."""
    from bench_port.yardstick.bounds_rmsnorm import rmsnorm_bounds

    cfg = json.loads((CONFIGS / "jamba2-3b.json").read_text())
    wl = {"micro_batch_size": 8, "compared_accumulation": 1, "remat": "block"}
    rows = 8 * 16384
    calls = {"fwd": [(112, 2560, True), (52, 160, False), (104, 16, False), (1, 2560, False)],
             "bwd": [(56, 2560, True), (26, 160, False), (52, 16, False), (1, 2560, False)]}[kind]
    bound = sum(n * rmsnorm_bounds(rows, c, "bfloat16", "bfloat16", res)[kind] for n, c, res in calls)
    bound /= sum(n for n, *_ in calls)
    events = []
    for corr, dur in enumerate([300.0, 100.0, 200.0]):
        events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": MAIN, "ts": 10.0 * corr, "dur": 2.0,
                       "args": {"correlation": corr}})
        events.append({"cat": "kernel", "name": f"void rmsnorm_{kind}_kernel<__nv_bfloat16>", "ts": 1000.0 * corr,
                       "dur": dur, "args": {"correlation": corr}})
    read = harness.load_metric(f"rmsnorm_{kind}_roofline.hybrid")
    r = harness.Reading(cfg, wl, {}, 1.0, DeviceTrace.from_events(events))
    assert read(r) == pytest.approx(100.0 * bound / 200e-6)
    assert read(harness.Reading(cfg, wl, {}, 1.0, DeviceTrace.from_events(events[:0]))) is None
